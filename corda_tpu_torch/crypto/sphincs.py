"""SPHINCS-256: stateless hash-based post-quantum signatures.

Port of corda_tpu/crypto/sphincs.py, the same construction and bytes
(hashlib only). Reference: the SPHINCS256_SHA512_256 scheme in the
reference's registry (core/.../crypto/Crypto.kt:161-170, backed by
BouncyCastle's PQC provider). The construction follows the SPHINCS
architecture (Bernstein et al., 2015) with its production parameters —
total tree height h=60 in d=12 layers of height-5 subtrees, WOTS+ with
w=16, and a HORST few-time signature with t=2^16 leaves / k=32 revealed
— built over SHA-256/SHA-512 via Python's hashlib. Signing and
verification run on the host in both packages: verification is ~7k
dependent hashes per signature, with no kernel in either.

Wire deviation note: the original SPHINCS-256 instantiates its hashes
with ChaCha12/BLAKE-256 and bitmasked trees; this implementation keeps
the identical structure and parameters over domain-separated SHA-256
(`F`/`H`/PRF below), so signatures are not byte-compatible with the
BouncyCastle scheme — the scheme is self-consistent across nodes (and
across the two packages) rather than wire-compatible with the JVM stack.

Sizes: pk 32 B, sk 64 B, signature 45,096 B. Keygen ≈ 32 WOTS+ key
loads; sign ≈ 550k hash calls; verify ≈ 7k.
"""

from __future__ import annotations

import hashlib
import struct

N = 32                 # hash output bytes (256 bit)
W = 16                 # Winternitz parameter
LOG_W = 4
WOTS_L1 = 64           # 256 / LOG_W message digits
WOTS_L2 = 3            # checksum digits: max sum 64*15=960 < 16^3
WOTS_L = WOTS_L1 + WOTS_L2
H_TOTAL = 60           # hyper-tree height
D_LAYERS = 12          # layers
H_SUB = H_TOTAL // D_LAYERS           # 5 → 32 WOTS leaves per subtree
HORST_LOG_T = 16
HORST_T = 1 << HORST_LOG_T
HORST_K = 32

SIG_SIZE = (
    N + 8                                   # randomizer R + leaf index
    + HORST_K * (N + HORST_LOG_T * N)       # HORST: sk + auth path each
    + D_LAYERS * (WOTS_L * N + H_SUB * N)   # per layer: WOTS sig + auth
)


def _F(x: bytes) -> bytes:
    """Chain/leaf hash (SPHINCS F)."""
    return hashlib.sha256(b"SPX256-F" + x).digest()


def _H(left: bytes, right: bytes) -> bytes:
    """Tree node hash (SPHINCS H)."""
    return hashlib.sha256(b"SPX256-H" + left + right).digest()


def _prf(seed: bytes, *addr: int) -> bytes:
    """Secret-element derivation, addressed by position in the
    hyper-tree (layer, subtree, leaf, chain...)."""
    return hashlib.sha256(
        b"SPX256-PRF" + seed + struct.pack(f">{len(addr)}Q", *addr)
    ).digest()


# -- WOTS+ -------------------------------------------------------------------


def _chain(x: bytes, steps: int) -> bytes:
    for _ in range(steps):
        x = _F(x)
    return x


def _wots_digits(msg32: bytes) -> list[int]:
    digits = []
    for b in msg32:
        digits.append(b >> 4)
        digits.append(b & 0xF)
    checksum = sum((W - 1) - d for d in digits)
    for shift in (8, 4, 0):
        digits.append((checksum >> shift) & 0xF)
    return digits                     # WOTS_L digits


def _wots_sk(seed: bytes, layer: int, subtree: int, leaf: int) -> list[bytes]:
    return [
        _prf(seed, 1, layer, subtree, leaf, i) for i in range(WOTS_L)
    ]


def _wots_pk_hash(sk: list[bytes]) -> bytes:
    return _F(b"".join(_chain(s, W - 1) for s in sk))


def _wots_sign(sk: list[bytes], msg32: bytes) -> list[bytes]:
    return [
        _chain(s, d) for s, d in zip(sk, _wots_digits(msg32))
    ]


def _wots_pk_from_sig(sig: list[bytes], msg32: bytes) -> bytes:
    return _F(
        b"".join(
            _chain(s, (W - 1) - d)
            for s, d in zip(sig, _wots_digits(msg32))
        )
    )


# -- Merkle helpers ----------------------------------------------------------


def _build_tree(leaves: list[bytes]) -> list[list[bytes]]:
    """All levels, bottom-up; len(leaves) must be a power of two."""
    levels = [leaves]
    while len(levels[-1]) > 1:
        prev = levels[-1]
        levels.append(
            [_H(prev[i], prev[i + 1]) for i in range(0, len(prev), 2)]
        )
    return levels


def _auth_path(levels: list[list[bytes]], index: int) -> list[bytes]:
    path = []
    for level in levels[:-1]:
        path.append(level[index ^ 1])
        index >>= 1
    return path


def _climb(leaf: bytes, index: int, path: list[bytes]) -> bytes:
    node = leaf
    for sibling in path:
        if index & 1:
            node = _H(sibling, node)
        else:
            node = _H(node, sibling)
        index >>= 1
    return node


# -- HORST -------------------------------------------------------------------


def _horst_indices(digest64: bytes) -> list[int]:
    """k=32 tree indices of 16 bits each — exactly one SHA-512 digest."""
    return list(struct.unpack(">32H", digest64))


def _horst_sign(seed: bytes, leaf_idx: int, digest64: bytes):
    sks = [_prf(seed, 2, leaf_idx, i) for i in range(HORST_T)]
    levels = _build_tree([_F(sk) for sk in sks])
    root = levels[-1][0]
    sig = [
        (sks[i], _auth_path(levels, i)) for i in _horst_indices(digest64)
    ]
    return sig, root


def _horst_root_from_sig(sig, digest64: bytes):
    root = None
    for idx, (sk, path) in zip(_horst_indices(digest64), sig):
        r = _climb(_F(sk), idx, path)
        if root is None:
            root = r
        elif r != root:
            return None
    return root


# -- the hyper-tree ----------------------------------------------------------


def _subtree(seed: bytes, layer: int, subtree_idx: int):
    """Build one height-5 subtree of WOTS+ leaf pk-hashes."""
    leaves = [
        _wots_pk_hash(_wots_sk(seed, layer, subtree_idx, leaf))
        for leaf in range(1 << H_SUB)
    ]
    return _build_tree(leaves)


def public_from_private(private: bytes) -> bytes:
    """The public key: root of the single top-layer subtree."""
    return _subtree(private[:N], D_LAYERS - 1, 0)[-1][0]


def keygen(seed: bytes) -> tuple[bytes, bytes]:
    """(private 64 B, public 32 B)."""
    sk1 = hashlib.sha256(b"SPX256-SK1" + seed).digest()
    sk2 = hashlib.sha256(b"SPX256-SK2" + seed).digest()
    private = sk1 + sk2
    return private, public_from_private(private)


def sign(private: bytes, message: bytes) -> bytes:
    sk1, sk2 = private[:N], private[N:]
    # deterministic randomizer + leaf choice (stateless few-time use:
    # idx varies per message, SPHINCS's PRF(sk2, m) move)
    r = hashlib.sha256(b"SPX256-R" + sk2 + message).digest()
    idx = int.from_bytes(r[:8], "big") >> (64 - H_TOTAL)
    digest = hashlib.sha512(r + message).digest()

    out = [r, struct.pack(">Q", idx)]
    horst_sig, cur_root = _horst_sign(sk1, idx, digest)
    for sk, path in horst_sig:
        out.append(sk)
        out.extend(path)
    for layer in range(D_LAYERS):
        leaf = (idx >> (H_SUB * layer)) & ((1 << H_SUB) - 1)
        subtree_idx = idx >> (H_SUB * (layer + 1))
        levels = _subtree(sk1, layer, subtree_idx)
        wsig = _wots_sign(
            _wots_sk(sk1, layer, subtree_idx, leaf), cur_root
        )
        out.extend(wsig)
        out.extend(_auth_path(levels, leaf))
        cur_root = levels[-1][0]
    sig = b"".join(out)
    assert len(sig) == SIG_SIZE
    return sig


def verify(public: bytes, signature: bytes, message: bytes) -> bool:
    if len(signature) != SIG_SIZE:
        return False
    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        chunk = signature[off:off + n]
        off += n
        return chunk

    r = take(N)
    (idx,) = struct.unpack(">Q", take(8))
    if idx >> H_TOTAL:
        return False
    digest = hashlib.sha512(r + message).digest()

    horst_sig = [
        (take(N), [take(N) for _ in range(HORST_LOG_T)])
        for _ in range(HORST_K)
    ]
    cur_root = _horst_root_from_sig(horst_sig, digest)
    if cur_root is None:
        return False
    for layer in range(D_LAYERS):
        leaf = (idx >> (H_SUB * layer)) & ((1 << H_SUB) - 1)
        wsig = [take(N) for _ in range(WOTS_L)]
        path = [take(N) for _ in range(H_SUB)]
        leaf_hash = _wots_pk_from_sig(wsig, cur_root)
        cur_root = _climb(leaf_hash, leaf, path)
    return cur_root == public
