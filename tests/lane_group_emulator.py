"""A lane-group emulator for the CUDA sources, compiled as host C++.

There is no nvcc and no card on the CPU test machines, so the kernel
host tests (`test_torch_kernel_host.py` for the ladders,
`test_torch_kernel_host_ends.py` for the verify prologues and
epilogues) compile a source of `corda_tpu_torch/csrc/` (with its
headers, from csrc/ as nvcc includes them) with the host C++ compiler
behind SHIM (`__device__`, `__global__`, `__shared__`, `threadIdx`, ...
defined away; the CUDA-runtime launcher section cut off) and a test's
own `main`.

A kernel that spreads a row over a group of TPI lanes
(`field256_group.cuh`) runs through `emu_run_group`: each of the group's
lanes is a coroutine (ucontext), run in turn. A lane that reaches a
`__shfl*_sync`, `__ballot_sync` or `__syncwarp` deposits its value and
passes to the next lane, so it reads only once every lane of the group
has deposited, as on the card. A ballot's bits of the warp's other
groups are noise, so a lane that fails to mask them out gets wrong
carries. Groups exchange no field words, so one group at a time
suffices; a block-wide table that thread 0 writes before its first
exchange is written before the first group reads it.

FIELD_BODY is a group body for one field operation per row (a `main`'s
mode 2): op 0 the source's multiply FIELD_MUL, 1 gfe_add, 2 gfe_sub, 3
its square FIELD_SQR (gfe_sqr_25519 beside gfe_mul_25519, gfe_sqr beside
gfe_mul) beside FIELD_MUL(a, a).

It checks arithmetic, carries between lanes, conversions and ragged
edges, not the GPU's compiler or memory model, which only chip_smoke.py
and tests/test_torch_gpu.py reach.
"""

import shutil
import subprocess

import pytest

from corda_tpu_torch.crypto.build import CSRC_DIR

SHIM = r"""
#include <stdint.h>
#include <string.h>
#include <stdio.h>
#include <stdlib.h>
#include <ucontext.h>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
struct Dim3 { int x; };
static Dim3 threadIdx, blockIdx;
static inline void __syncthreads() {}

// One group of lanes, each a coroutine, run in turn. A lane at an
// exchange deposits its value in slot set gen % 2 and passes on; when it
// runs again, every lane has deposited (a lane runs ahead by at most one
// exchange, hence two slot sets).
#define EMU_MAX 32
#define EMU_STACK (1 << 20)
static ucontext_t emu_main, emu_ctx[EMU_MAX];
static char* emu_stacks[EMU_MAX];
static int emu_lanes, emu_first, emu_cur, emu_done;
static bool emu_fin[EMU_MAX];
static long emu_gen[EMU_MAX];
static uint32_t emu_slot[2][EMU_MAX];
static void (*emu_body)();

static void emu_pass(int me) {   // run the next unfinished lane
  int next = me;
  do next = (next + 1) % emu_lanes; while (emu_fin[next]);
  emu_cur = next;
  threadIdx.x = emu_first + next;
  swapcontext(&emu_ctx[me], &emu_ctx[next]);
}

static void emu_entry() {
  emu_body();
  const int me = emu_cur;
  emu_fin[me] = true;
  if (++emu_done == emu_lanes) setcontext(&emu_main);
  emu_pass(me);
}

static void emu_run_group(int block, int first, int lanes, void (*body)()) {
  emu_lanes = lanes; emu_first = first; emu_done = 0; emu_body = body;
  blockIdx.x = block;
  for (int i = 0; i < lanes; ++i) {
    if (!emu_stacks[i]) emu_stacks[i] = (char*)malloc(EMU_STACK);
    emu_fin[i] = false; emu_gen[i] = 0;
    getcontext(&emu_ctx[i]);
    emu_ctx[i].uc_stack.ss_sp = emu_stacks[i];
    emu_ctx[i].uc_stack.ss_size = EMU_STACK;
    emu_ctx[i].uc_link = 0;
    makecontext(&emu_ctx[i], emu_entry, 0);
  }
  emu_cur = 0; threadIdx.x = first;
  swapcontext(&emu_main, &emu_ctx[0]);
  for (int i = 1; i < lanes; ++i)
    if (emu_gen[i] != emu_gen[0]) { fprintf(stderr, "lanes disagree on exchanges\n"); exit(5); }
}

static const uint32_t* emu_exchange(uint32_t v, long* gen) {
  const int me = emu_cur;
  if (emu_done) { fprintf(stderr, "lane %d exchanges after another lane ended\n", me); exit(5); }
  *gen = emu_gen[me]++;
  emu_slot[*gen & 1][me] = v;
  emu_pass(me);
  return emu_slot[*gen & 1];
}

static void emu_check_width(int width) {
  if (width != emu_lanes) { fprintf(stderr, "shuffle width %d, group %d\n", width, emu_lanes); exit(5); }
}

static uint32_t __shfl_sync(uint32_t, uint32_t v, int src, int width) {
  emu_check_width(width);
  long gen;
  return emu_exchange(v, &gen)[src % width];
}

static uint32_t __shfl_down_sync(uint32_t, uint32_t v, int delta, int width) {
  emu_check_width(width);
  long gen;
  const int me = emu_cur;
  const uint32_t* s = emu_exchange(v, &gen);
  return me + delta < width ? s[me + delta] : s[me];
}

static uint32_t __shfl_up_sync(uint32_t, uint32_t v, int delta, int width) {
  emu_check_width(width);
  long gen;
  const int me = emu_cur;
  const uint32_t* s = emu_exchange(v, &gen);
  return me >= delta ? s[me - delta] : s[me];
}

// the warp's other lanes answer noise, the same for every lane of the group
static uint32_t __ballot_sync(uint32_t, int pred) {
  long gen;
  const uint32_t* s = emu_exchange(pred != 0, &gen);
  uint32_t m = (uint32_t)(((uint64_t)gen + 1) * 0x9E3779B97F4A7C15ull >> 32);
  for (int i = 0; i < emu_lanes; ++i) {
    const int bit = (emu_first + i) % 32;
    m = (m & ~(1u << bit)) | ((s[i] ? 1u : 0u) << bit);
  }
  return m;
}

static void __syncwarp(uint32_t = 0xffffffffu) {
  long gen;
  emu_exchange(0, &gen);
}
"""

# One field operation per row for mode 2, on 8-word operands fa, fb:
# fr gets (a op b, b op a), or for op 3 (a^2 by FIELD_SQR, a * a by
# FIELD_MUL). The including main declares P and batch and sets the
# buffers, and names FIELD_MUL and FIELD_SQR.
FIELD_BODY = r"""
static const int32_t* fop;
static uint32_t *fa, *fb, *fr;
static void field_body() {
  const GroupField F = group_field(P);
  const int col = (blockIdx.x * BLOCK + threadIdx.x) / TPI;
  const int c = col < batch ? col : batch - 1;
  uint32_t a[WPL], b[WPL], r[WPL], s[WPL], w[NW];
  lane_words(a, fa + 8 * c, F.g);
  lane_words(b, fb + 8 * c, F.g);
  switch (fop[c]) {
    case 0: FIELD_MUL(r, a, b, F); FIELD_MUL(s, b, a, F); break;
    case 1: gfe_add(r, a, b, F); gfe_add(s, b, a, F); break;
    case 2: gfe_sub(r, a, b, F); gfe_sub(s, b, a, F); break;
    default: FIELD_SQR(r, a, F); FIELD_MUL(s, a, a, F); break;
  }
  group_gather(w, r, F);
  if (F.g == 0 && col < batch) memcpy(fr + 16 * col, w, sizeof(w));
  group_gather(w, s, F);
  if (F.g == 0 && col < batch) memcpy(fr + 16 * col + 8, w, sizeof(w));
}
"""


def compiler() -> str:
    """The host C++ compiler; skips the test where there is none."""
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    return cxx


def build(cxx: str, name: str, main: str, d):
    """csrc/<name>.cu up to its C interface, behind SHIM, with `main`,
    compiled into d/<name>; returns the executable's path."""
    src = (CSRC_DIR / f"{name}.cu").read_text()
    src = src.split("// C interface")[0].replace("#include <cuda_runtime.h>", "")
    (d / f"{name}.cpp").write_text(SHIM + src + main)
    exe = d / name
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-w", "-I", str(CSRC_DIR), "-o", str(exe), str(d / f"{name}.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return exe
