// Points over a group of TPI lanes (field256_group.cuh), shared by the
// ladder kernels (wei_ladder.cu, ed_ladder.cu): per-lane point tables in
// shared memory, a constant point's lane words, and the group's column.
// A point of C coordinates is C * WPL words in each lane (LPT words).

#pragma once

#include "field256_group.cuh"

// A per-lane point table in shared memory: word i of entry e of the lane
// at warp lane l sits at (e * LPT + i) * 32 + l, so every warp access
// covers 32 consecutive words (no bank conflict) whatever entry each
// group reads. A lane reads only the words it wrote: no barrier.
template <int LPT>
__device__ __forceinline__ void tab_put(uint32_t* tab, int e, const uint32_t pt[LPT]) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < LPT; ++i) tab[(e * LPT + i) * 32 + lane] = pt[i];
}

template <int LPT>
__device__ __forceinline__ void tab_get(uint32_t pt[LPT], const uint32_t* tab, int e) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < LPT; ++i) pt[i] = tab[(e * LPT + i) * 32 + lane];
}

// this lane's words of a constant point of C coordinates (8 words each)
template <int C>
__device__ __forceinline__ void const_point(uint32_t pt[C * WPL], const uint32_t w[C * NW], int g) {
#pragma unroll
    for (int c = 0; c < C; ++c) lane_words(pt + c * WPL, w + c * NW, g);
}

// the group's column; past the ragged edge a group computes on the last
// column (every lane must reach every shuffle) and stores nothing
template <int BLOCK_THREADS>
__device__ __forceinline__ int group_col(int batch, bool* live) {
    const int col = (blockIdx.x * BLOCK_THREADS + threadIdx.x) / TPI;
    *live = col < batch;
    return *live ? col : batch - 1;
}
