"""Host-side geometry of the bf16 forward kernel, csrc/flash_fwd_wgmma.cuh
(K1 and K2 on the card), and of the others below: the TMA tensor maps, the
padded head dim, the grid and the shared memory of one launch. `flash.py`
passes it to `vx_flash_fwd_tma` (csrc/flash_fwd.cu), which encodes the maps
from it; the CPU tests hold it to TMA's rules at every main-path shape. `tile` is the
tiling per head dim that csrc/flash_fwd_wgmma.cuh's WgmmaTile also sets; the
library reports its own through `vx_flash_fwd_tile`, and flash.py checks the
two against each other before a head dim's first launch.

Each of q, k, v (B, L, H*D), contiguous, is viewed as a 4-D tensor (D, H, L,
B) with element strides (1, D, H*D, L*H*D), so one (batch, head)'s tile of
rows is one box. A box is (CW, 1, rows, 1): CW = swizzle / 2 bf16 columns,
128 rows of q, `tile_k` rows of k and v. The kernel cuts the head dim into
ceil(NV / CW) such chunks, NV = D rounded up to the wgmma depth 16; TMA reads zeros past D.

T1 and T2 (csrc/flash_variants.cu, csrc/splash_fwd.cu) are the same kernel at
the attention-variant bench's tilings (`T1_TILES`, `T2_TILES`) over (B, H,
L, D) tensors. `variant_geometry` maps each tensor in its own memory order:
(D, L, H, B) for a contiguous one, (D, H, L, B) for a head-major view of a
packed (B, L, H*D) one, so the byte strides always rise with the dimension;
`row_dim` says where the rows are, and the kernel orders its box coordinates
by it. `variant_tile` is what the library reports through
`vx_flash_fwd_variant_tile` and `vx_splash_mha_tile`.

The fp32 forward (csrc/flash_fwd_tf32.cuh, 3xTF32) reads tf32 parts of q, k
and v that a split pass writes, through the maps of `f32_geometry`, at the
tiling `f32_tile` that `vx_flash_fwd_f32_tile` reports. The fp32 backward
(csrc/flash_bwd_tf32.cuh) reads the parts of q, k, v and do, and of q, do
and k transposed, through the maps of `f32_bwd_geometry`, at the tiling
`f32_bwd_tile` that `vx_flash_bwd_f32_tile` reports.

The backward's kernels (csrc/flash_bwd_wgmma.cuh, bf16 at D=40, 80 and 160)
read the same 4-D views in boxes of their ring tiles' rows (`bwd_geometry`:
64, or 32 queries for dk/dv at D=160), with the tiling `bwd_tile` that
csrc/flash_bwd_wgmma.cuh's BwdTile sets and `vx_flash_bwd_tile` reports;
`dkv_splits` chooses how many parts the dk/dv kernel cuts the query axis
into, and `dkv_parts` which query tiles each part walks, as the kernel
computes them.
"""

from __future__ import annotations

import ctypes
from typing import List

TILE_Q = 128  # query rows per block: two consumer warpgroups of 64
STAGES = 3  # K/V stages of the ring
THREADS = 384  # two consumer warpgroups and the producer's
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on an H100
ELEM = 2  # bf16
# swizzle span in bytes by head dim (csrc/flash_fwd.cu's VX_WGMMA): at D=40
# one 64-column chunk and at D=80 two, 128-byte swizzle, which beat 32-byte
# swizzle's three or five 16-column chunks on an H100 (PERF.md); D=160 takes
# five 32-column chunks (64 B)
SWIZZLE = {40: 128, 80: 128, 160: 64}
# what `tile` returns, in the order of csrc/flash_fwd.cu::vx_flash_fwd_tile,
# through which flash.py checks that the library was built to this table
TILE_FIELDS = ("swizzle", "box_cols", "tile_q", "tile_k", "blocks_per_sm", "smem", "threads",
               "stages")


def padded_head_dim(d: int) -> int:
    """NV: the head dim of the products, D rounded up to the wgmma depth 16."""
    return -(-d // 16) * 16


def tile_k(d: int) -> int:
    """Keys per stage (WgmmaTile::BK): 128 at D=80, 64 otherwise."""
    return 128 if d == 80 else 64


def blocks_per_sm(d: int) -> int:
    """Blocks the kernel is built to run side by side on one SM
    (WgmmaTile::MINB): two at D=40, one otherwise."""
    return 2 if d == 40 else 1


def _fwd_smem(nv: int, swizzle: int, tile_q: int, tile_k: int, stages: int, q_buffers: int) -> int:
    """WgmmaTile::SMEM: `q_buffers` Q tiles, `stages` stages of K and V, each
    cut into ceil(nv / (swizzle / 2)) chunks, the mbarriers, and 1024 bytes
    to align the base to the 128-byte swizzle's period."""
    chunks = -(-nv // (swizzle // 2))
    return (q_buffers * chunks * tile_q * swizzle + 2 * stages * chunks * tile_k * swizzle
            + 8 * (2 * stages + q_buffers) + 1024)


def smem_bytes(d: int, swizzle: int) -> int:
    """Dynamic shared memory of one block of K1's forward: the Q tile,
    STAGES stages of K and V, the mbarriers and the alignment slack."""
    return _fwd_smem(padded_head_dim(d), swizzle, TILE_Q, tile_k(d), STAGES, 1)


def tile(d: int) -> dict:
    """The kernel's tiling at head dim d, keyed by TILE_FIELDS (a head dim
    with no instantiation gets 128-byte swizzle, which `tma_violations` then
    names)."""
    sw = SWIZZLE.get(d, 128)
    return dict(swizzle=sw, box_cols=sw // 2, tile_q=TILE_Q, tile_k=tile_k(d),
                blocks_per_sm=blocks_per_sm(d), smem=smem_bytes(d, sw), threads=THREADS,
                stages=STAGES)


def _tensor_map(b: int, length: int, heads: int, d: int, rows: int, swizzle: int,
                elem: int = ELEM) -> dict:
    return dict(dims=(d, heads, length, b),
                strides=(d * elem, heads * d * elem, length * heads * d * elem),
                box=(swizzle // elem, 1, rows, 1))


def fwd_geometry(b: int, lq: int, lk: int, heads: int, d: int) -> dict:
    """Everything the host sets for one launch of the bf16 forward kernel."""
    t = tile(d)
    sw, cw = t["swizzle"], t["box_cols"]
    nv = padded_head_dim(d)
    chunks = -(-nv // cw)
    return dict(kernel="fwd", swizzle=sw, head_dim=d, padded_head_dim=nv, chunks=chunks,
                smem_head_dim=chunks * cw,
                q=_tensor_map(b, lq, heads, d, TILE_Q, sw),
                kv=_tensor_map(b, lk, heads, d, t["tile_k"], sw),
                grid=(-(-lq // TILE_Q), b * heads), threads=THREADS, smem=t["smem"],
                blocks_per_sm=t["blocks_per_sm"])


def _instantiated(geom: dict) -> bool:
    """Whether some instantiation of geom's kernel has its head dim and swizzle."""
    d, sw, kernel = geom["head_dim"], geom["swizzle"], geom["kernel"]
    if kernel in VARIANT_TILES:
        return d == VARIANT_HEAD_DIM and sw == VARIANT_SWIZZLE
    if kernel == "f32":
        return d in F32_TILES and F32_TILES[d][0] == sw
    if kernel in ("f32_dkv", "f32_dq"):
        return d in F32_BWD_TILES and sw == F32_BWD_SWIZZLE
    return (SWIZZLE if kernel == "fwd" else BWD_SWIZZLE).get(d) == sw


def tma_violations(geom: dict) -> List[str]:
    """What breaks cuTensorMapEncodeTiled's rules or the kernel's limits, as
    messages (none for a launch the kernel can take). The maps' byte strides
    must also rise with the dimension (each map is in its tensor's memory
    order)."""
    bad = []
    sw, elem = geom["swizzle"], geom.get("elem", ELEM)
    if not _instantiated(geom):
        bad.append(f"no instantiation for D={geom['head_dim']} at swizzle {sw}")
    for name in ("q", "kv", "vt", "qt", "kt"):
        if name not in geom:
            continue
        m = geom[name]
        sw = m.get("swizzle", geom["swizzle"])
        if not all(0 < n < 2**32 for n in m["dims"]):
            bad.append(f"{name}: dims {m['dims']} outside (0, 2^32)")
        if any(s % 16 or not 0 < s < 2**40 for s in m["strides"]):
            bad.append(f"{name}: byte strides {m['strides']} not multiples of 16 below 2^40")
        if list(m["strides"]) != sorted(m["strides"]) or m["strides"][0] < m["dims"][0] * elem:
            bad.append(f"{name}: byte strides {m['strides']} do not rise with the dimension "
                       f"(not the tensor's memory order)")
        if any(not 0 < n <= 256 for n in m["box"]):
            bad.append(f"{name}: box {m['box']} outside (0, 256]")
        row_bytes = m["box"][0] * elem
        if row_bytes % 16 or row_bytes > sw:
            bad.append(f"{name}: box rows of {row_bytes} bytes, not a multiple of 16 within "
                       f"the {sw}-byte swizzle span")
    if geom["smem"] * geom["blocks_per_sm"] > SMEM_LIMIT:
        bad.append(f"shared memory {geom['smem']} bytes a block, "
                   f"{geom['blocks_per_sm']} blocks an SM, above {SMEM_LIMIT}")
    if not 0 < geom["grid"][1] <= 65535:
        bad.append(f"grid y {geom['grid'][1]} outside (0, 65535]")
    if geom["kernel"] in VARIANT_TILES:
        bq, bk, _, hb = geom["tiling"]
        b, h, lq, lk = geom["shape"]
        if lq % bq or lk % bk:
            bad.append(f"Lq={lq}, Lk={lk} not whole tiles of {bq} queries and {bk} keys")
        if (b * h) % hb:
            bad.append(f"B*H={b * h} not whole blocks of {hb} (batch, head) pairs")
    elif geom["kernel"] == "f32":
        lk, bk = geom["kv"]["dims"][2], geom["kv"]["box"][2]
        if lk % bk:
            bad.append(f"Lk={lk} not whole tiles of {bk} keys")
    elif geom["kernel"] in ("f32_dkv", "f32_dq"):
        q_tiles = geom["q"]["dims"][2] // geom["ring_rows"] if geom["kernel"] == "f32_dkv" else 1
        if not 1 <= geom["grid"][2] <= q_tiles:
            bad.append(f"{geom['grid'][2]} parts of {q_tiles} query tiles")
        if any(m["dims"][2] % F32_BWD_ROWS for m in (geom["q"], geom["kv"])):
            bad.append(f"rows not whole {F32_BWD_ROWS}-row blocks")
        if geom["grid"][0] % geom["cluster"]:
            bad.append(f"grid x {geom['grid'][0]} not whole clusters of {geom['cluster']}")
    elif geom["kernel"] != "fwd":
        walked = geom["q"]["dims"][2] // BWD_WG_ROWS  # 64-row query tiles the dk/dv parts share
        if not 1 <= geom["grid"][2] <= (walked if geom["kernel"] == "dkv" else 1):
            bad.append(f"{geom['grid'][2]} parts of {walked} query tiles")
        if any(m["dims"][2] % BWD_WG_ROWS for m in (geom["q"], geom["kv"])):
            bad.append(f"rows not whole {BWD_WG_ROWS}-row tiles")
    return bad


def geometry_arg(geom: dict):
    """The int64 array `vx_flash_fwd_tma` reads: swizzle, box columns, box
    rows of q and of k/v, grid x and y, shared memory, q's dims and byte
    strides, k's dims and byte strides (each map's dims in its own order)."""
    q, kv = geom["q"], geom["kv"]
    vals = [geom["swizzle"], q["box"][0], q["box"][q.get("row_dim", 2)],
            kv["box"][kv.get("row_dim", 2)], *geom["grid"], geom["smem"], *q["dims"],
            *q["strides"], *kv["dims"], *kv["strides"]]
    return (ctypes.c_longlong * len(vals))(*vals)


# ----------------------------------------------------------------- T1, T2
VARIANT_HEAD_DIM = 40  # the bench's head dim, the only one instantiated
VARIANT_SWIZZLE = 128  # 64-column chunks: one at a product head dim of 48 or 64, two at 128
# (block_q, block_k, product head dim, heads_per_block) -> (blocks_per_sm,
# stages) of each T1 instantiation (csrc/flash_variants.cu's VX_T1_ROWS): two
# blocks an SM (three or four 64-row blocks were no faster, PERF.md §6) with
# the deepest ring that fits them: 6 stages at 64 keys, 5 beside Q's second
# buffer, 2 at 128 keys or 128 product columns, K1's 3 at 128 query rows
T1_TILES = {(64, 64, 48, 1): (2, 6), (64, 64, 64, 1): (2, 6), (64, 64, 128, 1): (2, 2),
            (64, 64, 48, 2): (2, 5), (128, 64, 48, 2): (2, 3), (64, 128, 48, 2): (2, 2),
            (64, 64, 48, 4): (2, 5), (128, 64, 48, 4): (2, 3), (64, 128, 48, 4): (2, 2)}
# (block_q, block_kv, product head dim) -> (blocks_per_sm, stages) of each T2
# instantiation (csrc/splash_fwd.cu's VX_T2_ROWS): as T1's at 64 query rows;
# at 128 rows and 128 keys one block, whose consumers hold P's two fragments
# in 240 registers
T2_TILES = {(64, 64, 48): (2, 6), (64, 64, 64): (2, 6), (128, 128, 48): (1, 3)}
VARIANT_TILES = {"t1": T1_TILES, "t2": T2_TILES}
# what `variant_tile` returns, in the order of vx_flash_fwd_variant_tile and
# vx_splash_mha_tile
VARIANT_TILE_FIELDS = ("tile_q", "tile_k", "d_pad", "heads_per_block", "swizzle", "box_cols",
                       "blocks_per_sm", "stages", "smem", "threads")


def _tiling4(kind: str, tiling: tuple) -> tuple:
    """(block_q, block_k, d_pad, heads_per_block): T2's tilings have one pair a block."""
    return tuple(tiling) if kind == "t1" else tuple(tiling) + (1,)


def variant_tile(kind: str, tiling: tuple) -> dict:
    """The tiling of T1's (`kind` "t1") or T2's ("t2") instantiation at
    `tiling` (a key of T1_TILES or T2_TILES), keyed by VARIANT_TILE_FIELDS.
    A tiling with no instantiation gets one block an SM and 3 stages, and is
    left to the launch to refuse."""
    bq, bk, nv, hb = _tiling4(kind, tiling)
    minb, stages = VARIANT_TILES[kind].get(tuple(tiling), (1, 3))
    return dict(tile_q=bq, tile_k=bk, d_pad=nv, heads_per_block=hb, swizzle=VARIANT_SWIZZLE,
                box_cols=VARIANT_SWIZZLE // 2, blocks_per_sm=minb, stages=stages,
                smem=_fwd_smem(nv, VARIANT_SWIZZLE, bq, bk, stages, 2 if hb > 1 else 1),
                threads=128 * (bq // 64 + 1))


def strided_map(b: int, heads: int, length: int, d: int, strides: tuple, rows: int,
                swizzle: int) -> dict:
    """The map of a (B, H, L, D) tensor with element strides `strides` of
    (batch, head, row) and a contiguous head dim, in its memory order: (D, L,
    H, B) where rows lie closer than heads (row_dim 1), else (D, H, L, B)
    (row_dim 2); the box (swizzle / 2 columns, `rows` rows) in the same order."""
    sb, sh, sl = strides
    cols = swizzle // 2
    if sl < sh:
        return dict(dims=(d, length, heads, b), strides=(sl * ELEM, sh * ELEM, sb * ELEM),
                    box=(cols, rows, 1, 1), row_dim=1)
    return dict(dims=(d, heads, length, b), strides=(sh * ELEM, sl * ELEM, sb * ELEM),
                box=(cols, 1, rows, 1), row_dim=2)


def variant_geometry(kind: str, tiling: tuple, b: int, heads: int, lq: int, lk: int, d: int,
                     q_strides: tuple, kv_strides: tuple) -> dict:
    """Everything the host sets for one launch of T1 (`kind` "t1") or T2
    ("t2") at `tiling` over (B, H, L, D) tensors: q's and k/v's maps from
    their (batch, head, row) element strides, grid (ceil(Lq / block_q),
    B*H / heads_per_block), threads, shared memory, blocks per SM."""
    t = variant_tile(kind, tiling)
    sw, nv = t["swizzle"], t["d_pad"]
    return dict(kernel=kind, tiling=_tiling4(kind, tiling), shape=(b, heads, lq, lk),
                swizzle=sw, head_dim=d, padded_head_dim=nv, chunks=-(-nv // t["box_cols"]),
                q=strided_map(b, heads, lq, d, q_strides, t["tile_q"], sw),
                kv=strided_map(b, heads, lk, d, kv_strides, t["tile_k"], sw),
                grid=(-(-lq // t["tile_q"]), b * heads // t["heads_per_block"]),
                threads=t["threads"], smem=t["smem"], blocks_per_sm=t["blocks_per_sm"])


def variant_geometry_arg(geom: dict):
    """The int64 array `vx_flash_fwd_variant` and `vx_splash_mha_fwd` read:
    `geometry_arg`'s 21 values, then the order bits (1: q's map has its rows
    in dim 1; 2: k's and v's)."""
    order = (geom["q"]["row_dim"] == 1) | 2 * (geom["kv"]["row_dim"] == 1)
    vals = [*geometry_arg(geom), order]
    return (ctypes.c_longlong * len(vals))(*vals)


# ------------------------------------------------------------------ backward
# swizzle span by head dim of the backward's instantiations (csrc/flash_bwd.cu's
# VX_BWD_WGMMA): the forward's layout at every head dim
BWD_SWIZZLE = {40: 128, 80: 128, 160: 64}
BWD_WG_ROWS = 64  # keys (dk/dv) or queries (dq) of a consumer warpgroup
BWD_BLOCK = 128  # keys (dk/dv) or queries (dq) of a block: two consumer warpgroups
# (rows of a ring tile and of every box, ring stages) of each backward kernel
# by head dim (flash_bwd_wgmma.cuh's DkvTile, DqTile): 64-row tiles, a fourth
# stage speeds dq up and not dk/dv (PERF.md §6); at D=160 dk/dv walks
# 32-query tiles (a consumer's dK and dV take 160 registers, so S^T and dP^T
# get 16 each) in 4 stages, and dq keeps 3 (a fourth of 40 KiB does not fit)
BWD_RING = {"dkv": {40: (64, 3), 80: (64, 3), 160: (32, 4)},
            "dq": {40: (64, 4), 80: (64, 4), 160: (64, 3)}}
N_SMS = 132  # SMs of an H100 SXM: the dk/dv kernel's parts fill one wave of blocks
# what `bwd_tile` returns, in the order of csrc/flash_bwd.cu::vx_flash_bwd_tile
BWD_TILE_FIELDS = ("swizzle", "box_cols", "dkv_rows", "dq_rows", "block_rows", "dkv_stages",
                   "dq_stages", "dkv_smem", "dq_smem", "threads")


def bwd_ring(d: int, kernel: str) -> tuple:
    """(ring tile rows, stages) of `kernel` ("dkv" or "dq") at head dim d;
    a head dim with no instantiation gets D=40's."""
    return BWD_RING[kernel].get(d, BWD_RING[kernel][40])


def bwd_smem_bytes(d: int, swizzle: int, rows: int, stages: int) -> int:
    """Dynamic shared memory of one backward block (BwdTile::SMEM): two fixed
    128-row tiles, `stages` stages of two `rows`-row tiles, the lse and di
    values, the mbarriers and 1024 bytes of alignment slack."""
    chunks = -(-padded_head_dim(d) // (swizzle // 2))
    fixed = chunks * BWD_BLOCK * swizzle
    ring = chunks * rows * swizzle
    stats = max(stages * 2 * rows * 4, 2 * BWD_BLOCK * 4)
    return 2 * fixed + 2 * stages * ring + stats + 8 * (2 * stages + 1) + 1024


def bwd_tile(d: int) -> dict:
    """The backward kernels' tiling at head dim d, keyed by BWD_TILE_FIELDS
    (one block an SM; a head dim with no instantiation gets 128-byte
    swizzle, which `tma_violations` then names)."""
    sw = BWD_SWIZZLE.get(d, 128)
    (kv_rows, kv_stages), (q_rows, q_stages) = bwd_ring(d, "dkv"), bwd_ring(d, "dq")
    return dict(swizzle=sw, box_cols=sw // 2, dkv_rows=kv_rows, dq_rows=q_rows,
                block_rows=BWD_BLOCK, dkv_stages=kv_stages, dq_stages=q_stages,
                dkv_smem=bwd_smem_bytes(d, sw, kv_rows, kv_stages),
                dq_smem=bwd_smem_bytes(d, sw, q_rows, q_stages), threads=THREADS)


def dkv_splits(b: int, heads: int, lq: int, lk: int) -> int:
    """Parts of the query axis for the dk/dv kernel: 1 where its B*H*
    ceil(Lk/128) blocks fill the card's N_SMS SMs; otherwise the most parts
    that still run in one wave, and no more than there are 64-row query
    tiles. Depends on the shape alone, so a shape's sum is always taken in
    the same order."""
    blocks = b * heads * -(-lk // BWD_BLOCK)
    return max(1, min(N_SMS // blocks, lq // BWD_WG_ROWS))


def dkv_parts(lq: int, parts: int, rows: int) -> List[tuple]:
    """[start, end) query tiles (`rows` rows each, the dk/dv kernel's ring
    tiles) that each part walks, as the dk/dv kernel computes them: part p
    from p*T//parts to (p+1)*T//parts of the T = Lq/rows tiles."""
    tiles = lq // rows
    return [(p * tiles // parts, (p + 1) * tiles // parts) for p in range(parts)]


def bwd_geometry(b: int, lq: int, lk: int, heads: int, d: int, kernel: str) -> dict:
    """Everything the host sets for one launch of the backward's `kernel`
    ("dkv" or "dq"): the maps of q (and dO) and k (and v) with boxes of the
    kernel's ring-tile rows, the grid (blocks along Lk for dk/dv and along Lq
    for dq, B*H, parts of the query axis), the shared memory."""
    if kernel not in ("dkv", "dq"):
        raise ValueError(f"backward kernel {kernel!r}: 'dkv' or 'dq'")
    t = bwd_tile(d)
    sw, cw, rows = t["swizzle"], t["box_cols"], t[f"{kernel}_rows"]
    nv = padded_head_dim(d)
    chunks = -(-nv // cw)
    blocks_along = lk if kernel == "dkv" else lq
    parts = dkv_splits(b, heads, lq, lk) if kernel == "dkv" else 1
    return dict(kernel=kernel, swizzle=sw, head_dim=d, padded_head_dim=nv, chunks=chunks,
                smem_head_dim=chunks * cw,
                q=_tensor_map(b, lq, heads, d, rows, sw),
                kv=_tensor_map(b, lk, heads, d, rows, sw),
                grid=(-(-blocks_along // BWD_BLOCK), b * heads, parts), threads=THREADS,
                smem=t[f"{kernel}_smem"], blocks_per_sm=1)


def bwd_geometry_arg(geom: dict):
    """The int64 array `vx_flash_bwd_dkv_tma` and `vx_flash_bwd_dq_tma`
    read: swizzle, box columns, box rows, grid x, y and z, shared memory,
    q's dims and byte strides, k's dims and byte strides."""
    q, kv = geom["q"], geom["kv"]
    vals = [geom["swizzle"], q["box"][0], q["box"][2], *geom["grid"], geom["smem"], *q["dims"],
            *q["strides"], *kv["dims"], *kv["strides"]]
    return (ctypes.c_longlong * len(vals))(*vals)


# ---------------------------------------------------------------------- fp32
# The fp32 forward (K1's and K2's fp32 variants; csrc/flash_fwd_tf32.cuh) on
# the TF32 tensor cores: the split pass writes each of q, k and v as tf32 hi
# and lo parts into a scratch buffer (v's transposed to (B, H, D, Lk)), and
# the kernel reads the parts by TMA. Q's and K's parts are viewed as q's and
# k's (D, H, L, B) with 4-byte elements, in chunks of swizzle / 4 columns; V^T's
# as (Lk, D, H, B), in chunks of v_swizzle / 4 keys of D rows.
F32_ELEM = 4
# head dim -> (swizzle bytes of Q's and K's chunks, query rows, keys a tile)
# (csrc/flash_fwd.cu's VX_F32): 64-byte chunks at D=40 (3 of 16 columns, 48
# in shared memory) and D=80 (5, none padded), 128-byte at D=160 (5); 128
# query rows (two consumer warpgroups), 64 at D=160, whose two Q parts of 128
# rows would take 160 KiB; the widest key tile at which 3 stages fit beside Q
F32_TILES = {40: (64, 128, 64), 80: (64, 128, 32), 160: (128, 64, 16)}
F32_STAGES = 3
# what `f32_tile` returns, in the order of csrc/flash_fwd.cu::vx_flash_fwd_f32_tile
F32_TILE_FIELDS = ("swizzle", "box_cols", "v_swizzle", "v_box_cols", "tile_q", "tile_k",
                   "blocks_per_sm", "smem", "threads", "stages")


def f32_tile(d: int) -> dict:
    """The fp32 kernel's tiling at head dim d, keyed by F32_TILE_FIELDS
    (Tf32Tile in csrc/flash_fwd_tf32.cuh): shared memory holds Q's two parts
    (ceil(d / box_cols) chunks of tile_q rows), F32_STAGES stages of K's two
    parts and V^T's two parts (tile_k / v_box_cols chunks of d rows), the
    mbarriers and 1024 bytes of alignment slack. A head dim with no
    instantiation gets 128-byte chunks, which `tma_violations` then names."""
    sw, bq, bk = F32_TILES.get(d, (128, 128, 64))
    cw, swv = sw // F32_ELEM, min(128, bk * F32_ELEM)
    cwv = swv // F32_ELEM
    chunks = -(-d // cw)
    q_part, k_part, v_part = chunks * bq * sw, chunks * bk * sw, bk // cwv * d * swv
    smem = (2 * q_part + F32_STAGES * (2 * k_part + 2 * v_part) + 8 * (2 * F32_STAGES + 1)
            + 1024)
    return dict(swizzle=sw, box_cols=cw, v_swizzle=swv, v_box_cols=cwv, tile_q=bq, tile_k=bk,
                blocks_per_sm=1, smem=smem, threads=128 * (bq // 64 + 1), stages=F32_STAGES)


def f32_geometry(b: int, lq: int, lk: int, heads: int, d: int) -> dict:
    """Everything the host sets for one launch of the fp32 kernel: the maps
    of Q's parts (q's layout), K's (k's) and V^T's ((B, H, D, Lk)), the grid
    (ceil(Lq / tile_q), B*H), the shared memory; and the scratch floats of
    the parts (2 of q's size, 4 of k's)."""
    t = f32_tile(d)
    sw, swv, e = t["swizzle"], t["v_swizzle"], F32_ELEM
    return dict(kernel="f32", elem=e, swizzle=sw, head_dim=d, chunks=-(-d // t["box_cols"]),
                q=_tensor_map(b, lq, heads, d, t["tile_q"], sw, e),
                kv=_tensor_map(b, lk, heads, d, t["tile_k"], sw, e),
                vt=dict(dims=(lk, d, heads, b), strides=(lk * e, d * lk * e, heads * d * lk * e),
                        box=(t["v_box_cols"], d, 1, 1), row_dim=1, swizzle=swv),
                grid=(-(-lq // t["tile_q"]), b * heads), threads=t["threads"], smem=t["smem"],
                blocks_per_sm=1, scratch_floats=2 * b * lq * heads * d + 4 * b * lk * heads * d)


def f32_geometry_arg(geom: dict):
    """The int64 array `vx_flash_fwd_f32` reads: swizzle and box columns of
    Q and K, of V^T, query rows and keys a tile, grid x and y, shared memory,
    then the dims and byte strides of Q's, K's and V^T's maps."""
    q, kv, vt = geom["q"], geom["kv"], geom["vt"]
    vals = [geom["swizzle"], q["box"][0], vt["swizzle"], vt["box"][0], q["box"][2],
            kv["box"][2], *geom["grid"], geom["smem"]]
    for m in (q, kv, vt):
        vals += [*m["dims"], *m["strides"]]
    return (ctypes.c_longlong * len(vals))(*vals)


# ------------------------------------------------------------- fp32 backward
# K1's fp32 backward (csrc/flash_bwd_tf32.cuh) on the TF32 tensor cores: the
# split pass writes q, k, v and do as tf32 hi and lo parts in their own
# layout (viewed as (D, H, L, B), 16-column chunks in the 64-byte swizzle)
# and, for the RS products' B operands, q, do (dk/dv) and k (dq) transposed
# to (B, H, D, L) (viewed as (L, D, H, B): boxes of R columns by the CTA's
# head-dim rows, R * 4 bytes their swizzle span). A CTA holds 64 keys
# (dk/dv) or 64 queries (dq) on one consumer warpgroup and walks the other
# axis in ring tiles of R rows; at D=160 two CTAs of a cluster share a block,
# 80 head-dim columns each.
F32_BWD_SWIZZLE = 64
F32_BWD_ROWS = 64  # keys (dk/dv) or queries (dq) of a block
F32_BWD_THREADS = 256  # the consumer warpgroup and the producer's
# head dim -> (CTAs a cluster, (dk/dv ring rows, stages), (dq ring rows,
# stages)) (csrc/flash_bwd.cu's VX_BWD_F32): 32-row tiles at D=40; at D=80
# a consumer's dK and dV sums and their tile products take 160 of its 255
# registers, so 16-row tiles; D=160 is D=80's on each of a cluster's two CTAs
F32_BWD_TILES = {40: (1, (32, 3), (32, 4)), 80: (1, (16, 3), (16, 4)),
                 160: (2, (16, 3), (16, 4))}
# what `f32_bwd_tile` returns, in the order of csrc/flash_bwd.cu::vx_flash_bwd_f32_tile
F32_BWD_TILE_FIELDS = ("swizzle", "box_cols", "cluster", "dkv_rows", "dkv_stages", "dkv_smem",
                       "dq_rows", "dq_stages", "dq_smem", "threads")


def f32_bwd_smem(d: int, cluster: int, rows: int, stages: int, transposed: int) -> int:
    """Tf32BwdTile::SMEM: the four parts (hi, lo of two operands) of the
    block's 64 fixed rows, `stages` stages of the four parts of `rows` rows
    of the two streamed operands and the hi and lo of `transposed` transposed
    ones, lse and di (dk/dv: `rows` each a stage; dq: 64 each once), with two
    CTAs the two buffers of the other's partial S and dP, the mbarriers and
    1024 bytes of alignment slack; the CTA's head dim d / cluster."""
    dh = d // cluster
    chunk_cols = F32_BWD_SWIZZLE // F32_ELEM
    row_part = -(-dh // chunk_cols) * F32_BWD_SWIZZLE  # bytes a row of a row-major part
    fixed = 4 * F32_BWD_ROWS * row_part
    stage = 4 * rows * row_part + 2 * transposed * dh * rows * F32_ELEM
    stats = (stages * 2 * rows if transposed == 2 else 2 * F32_BWD_ROWS) * F32_ELEM
    exchange = 2 * 2 * F32_BWD_ROWS * rows * F32_ELEM if cluster > 1 else 0
    return fixed + stages * stage + stats + exchange + 8 * (2 * stages + 3) + 1024


def f32_bwd_tile(d: int) -> dict:
    """The fp32 backward kernels' tiling at head dim d, keyed by
    F32_BWD_TILE_FIELDS (one CTA an SM). A head dim with no instantiation
    gets D=40's, and is left to `tma_violations` and the launch to refuse."""
    cluster, (kv_rows, kv_stages), (q_rows, q_stages) = F32_BWD_TILES.get(d, F32_BWD_TILES[40])
    return dict(swizzle=F32_BWD_SWIZZLE, box_cols=F32_BWD_SWIZZLE // F32_ELEM, cluster=cluster,
                dkv_rows=kv_rows, dkv_stages=kv_stages,
                dkv_smem=f32_bwd_smem(d, cluster, kv_rows, kv_stages, 2),
                dq_rows=q_rows, dq_stages=q_stages,
                dq_smem=f32_bwd_smem(d, cluster, q_rows, q_stages, 1), threads=F32_BWD_THREADS)


def f32_dkv_splits(b: int, heads: int, lq: int, lk: int, d: int) -> int:
    """Parts of the query axis for the fp32 dk/dv kernel, as `dkv_splits`
    for the bf16 one: 1 where its B*H*(Lk/64)*cluster CTAs fill the card's
    N_SMS SMs, otherwise the most parts that still run in one wave, and no
    more than there are ring tiles of queries."""
    t = f32_bwd_tile(d)
    ctas = b * heads * -(-lk // F32_BWD_ROWS) * t["cluster"]
    return max(1, min(N_SMS // ctas, lq // t["dkv_rows"]))


def f32_bwd_geometry(b: int, lq: int, lk: int, heads: int, d: int, kernel: str) -> dict:
    """Everything the host sets for one launch of the fp32 backward's
    `kernel` ("dkv" or "dq"): the maps of the row-major parts of q's size
    (q, do) and k's (k, v), their boxes the fixed operands' 64 rows or the
    ring tiles' rows, and of the transposed parts of q's size (dk/dv) or k's
    (dq); the grid (blocks of 64 along Lk for dk/dv and along Lq for dq,
    times the cluster's CTAs; B*H; the query parts), the shared memory."""
    if kernel not in ("dkv", "dq"):
        raise ValueError(f"backward kernel {kernel!r}: 'dkv' or 'dq'")
    t = f32_bwd_tile(d)
    e, sw, cl = F32_ELEM, t["swizzle"], t["cluster"]
    rows, stages = t[f"{kernel}_rows"], t[f"{kernel}_stages"]
    dh = d // cl
    q_rows, kv_rows = (rows, F32_BWD_ROWS) if kernel == "dkv" else (F32_BWD_ROWS, rows)

    def transposed(length):
        return dict(dims=(length, d, heads, b), strides=(length * e, d * length * e,
                                                         heads * d * length * e),
                    box=(rows, dh, 1, 1), row_dim=1, swizzle=rows * e)

    along = lk if kernel == "dkv" else lq
    parts = f32_dkv_splits(b, heads, lq, lk, d) if kernel == "dkv" else 1
    geom = dict(kernel=f"f32_{kernel}", elem=e, swizzle=sw, head_dim=d, cluster=cl,
                ring_rows=rows, stages=stages,
                q=_tensor_map(b, lq, heads, d, q_rows, sw, e),
                kv=_tensor_map(b, lk, heads, d, kv_rows, sw, e),
                grid=(-(-along // F32_BWD_ROWS) * cl, b * heads, parts),
                threads=t["threads"], smem=t[f"{kernel}_smem"], blocks_per_sm=1)
    geom["qt" if kernel == "dkv" else "kt"] = transposed(lq if kernel == "dkv" else lk)
    return geom


def f32_bwd_geometry_arg(geom: dict):
    """The int64 array `vx_flash_bwd_dkv_f32` and `vx_flash_bwd_dq_f32`
    read: head dim, CTAs a cluster, ring rows, stages, grid x, y and z,
    shared memory, then the dims and byte strides of the maps of the
    row-major parts of q's size and of k's size, and of the transposed parts
    of q's size and of k's size (zeros for the one the kernel does not
    read)."""
    vals = [geom["head_dim"], geom["cluster"], geom["ring_rows"], geom["stages"], *geom["grid"],
            geom["smem"]]
    for name in ("q", "kv", "qt", "kt"):
        m = geom.get(name)
        vals += [*m["dims"], *m["strides"]] if m else [0] * 7
    return (ctypes.c_longlong * len(vals))(*vals)
