"""Linked SwiGLU MLP: the CUDA kernels' wrapper, their planner and their
plain version.

``linked_mlp(x, wg, wu, wd)`` computes ``(silu(x @ wg) * (x @ wu)) @ wd``
for x (..., d), wg and wu (d, ff), wd (ff, d), with the Pallas body's
arithmetic: both up-projections accumulate in fp32, the hidden activation
h is rounded to x's dtype before the down-projection, and the
down-projection accumulates in fp32 and is cast to x's dtype once.  (The
Pallas kernel accumulates y in the output block's dtype, rounding every
ff block's partial sum in bf16; the port accumulates in fp32.)  For CUDA
tensors it launches one of the two kernels of ``csrc/linked_mlp.cu`` on
the current stream, both of which keep h on chip: the tensor-core kernel
(``tc``) for the bf16 shapes it takes, the FFMA kernel (``ffma``) for the
rest; :func:`mlp_plan` chooses, from the shapes alone, and sizes the
grid.  The tensor-core kernel has three bodies: ``swap`` (the operands
swapped, so that one cluster covers all of d: gᵀ = Wgᵀ xᵀ, yᵀ += Wdᵀ hᵀ,
fed by TMA) at decode rows, ``decode`` (64-row tiles, ``cp.async``) for
the other rows below :data:`PREFILL_ROWS` and ``prefill`` (128-row
tiles fed by TMA, warp-specialised) from there on (:func:`tc_body`).
For CPU tensors it runs :func:`linked_mlp_plain`.  Nothing on the CUDA
path falls back to the plain version, and ragged M, d and ff are masked
in the kernels.

:func:`mlp_reference` is the bf16 check that the card tests and
``chip_smoke.py`` hold both the kernel and the plain version to: the
fp64-summed MLP with a limit that admits one bf16 step of every h
element a correct fp32 order can round apart from the fp64 h.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from .. import (CTA_SMEM_MAX, check_launch, count_launch, library,
                refuse_grad, sm_count)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: the tensor-core kernel: rows an M tile, ff columns a block, y columns a
#: CTA owns, the largest cluster (non-portable past TC_PORTABLE) and the
#: largest portable one
TC_BM, TC_BF, TC_DS, TC_MAX_CLUSTER, TC_PORTABLE = 64, 64, 256, 16, 8
#: its prefill body: rows an M tile (two consumer warpgroups of 64) and y
#: columns a CTA owns
TP_BM, TP_DS = 128, 128
#: rows from which the tensor-core kernel takes its prefill body: past
#: one 64-row tile of the decode body (mlp_plan's docstring)
PREFILL_ROWS = 65
#: its swap body (operands swapped at decode rows): y columns of a down
#: product (wgmma's M), the rows it pads M to (wgmma's N), the most y
#: tiles a rank owns (64 fp32 registers a thread of y: min(16, 256 / N))
#: and the rows it is planned at: up to SWAP_ROWS at every width, up to
#: 64 past d SWAP_WIDE_D (mlp_plan's docstring)
TS_TILE, TS_ROWS, TS_MAX_TILES = 64, (8, 16, 32, 64), 16
SWAP_ROWS, SWAP_WIDE_D = 32, 2048
#: the FFMA kernel: ff columns a block, warps a CTA
FFMA_BF, FFMA_WARPS = 64, 8


class MlpPlan(NamedTuple):
    """How one call runs.  ``path``: "tc" or "ffma".  ``bm``: rows an M
    tile.  ``cl``: CTAs a cluster, sharing h (tc, whose
    ``ceil(d / (ds cl))`` clusters split d: :func:`tc_columns`; the
    swap body's one cluster covers d: :func:`swap_ds`; 1 for ffma).
    ``S``: splits of ff.  ``v``: elements an FFMA lane loads at once (16
    bytes or 2; 8 for tc).  ``workspace``: fp32 elements of the (S, M, d)
    partial-y workspace (0: y is stored directly).  ``body``: the
    tensor-core kernel's "decode", "swap" or "prefill" body ("ffma" for
    the FFMA kernel); the swap body's ``bm`` is M padded to wgmma's N."""
    path: str
    bm: int
    cl: int
    S: int
    v: int
    workspace: int
    body: str = "decode"


def linked_mlp_plain(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                     wd: torch.Tensor) -> torch.Tensor:
    """The unlinked form: fp32 up-projections, h rounded to x's dtype,
    fp32 down-projection, one cast at the end."""
    xf = x.float()
    h = (F.silu(xf @ wg.float()) * (xf @ wu.float())).to(x.dtype)
    return (h.float() @ wd.float()).to(x.dtype)


#: how far a correct fp32 summation order of an up-projection may move h
#: from its fp64 value, in units of 2^-24 sqrt(d) times each sum's terms'
#: 2-norm (carried through silu(g) u): over four times what the plain
#: version and 16- and 64-deep stepped orders move it
#: (tests/test_torch_mlp_prefill.py)
H_ORDER_MARGIN = 16.0


def _bf16_ulp(h: torch.Tensor) -> torch.Tensor:
    """One bf16 step at |h| (8 significand bits); 0 at h == 0."""
    e = torch.frexp(h)[1]
    return torch.where(h == 0, torch.zeros_like(h),
                       torch.ldexp(torch.ones_like(h), e - 8))


def h_rounding_slack(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                     wd: torch.Tensor, g: torch.Tensor | None = None,
                     u: torch.Tensor | None = None) -> torch.Tensor:
    """How far two correct bf16 MLPs may land apart through h's rounding
    alone, (M, d) in fp64: ``slack[i, k] = sum_j ulp(h[i, j]) |wd[j, k]|``
    over the h elements that a correct fp32 order of the up-projections
    can round to another bf16 value than the fp64 h does: those whose
    fp64 value lies within the orders' reach (``H_ORDER_MARGIN`` 2^-24
    sqrt(d) times each sum's terms' 2-norm, carried through silu(g) u) of
    a rounding midpoint.  ``g`` / ``u``: x @ wg / x @ wu in fp64, where
    the caller has them."""
    x64, g64, u64 = (a.double() for a in (x, wg, wu))
    g = x64 @ g64 if g is None else g
    u = x64 @ u64 if u is None else u
    sig = torch.sigmoid(g)
    h = g * sig * u
    x2 = x64 * x64
    reach = (H_ORDER_MARGIN * 2.0 ** -24 * x.shape[-1] ** 0.5) * (
        (sig * (1 + g * (1 - sig)) * u).abs() * (x2 @ (g64 * g64)).sqrt()
        + (g * sig).abs() * (x2 @ (u64 * u64)).sqrt())
    ulp = _bf16_ulp(h)
    q = h.abs() / torch.where(ulp > 0, ulp, torch.ones_like(ulp))
    to_mid = (q - q.floor() - 0.5).abs() * ulp
    # a reach past a quarter step may cross into the next binade's grid
    near = (to_mid <= reach) | (4 * reach >= ulp)
    return torch.where(near, ulp, torch.zeros_like(ulp)) @ wd.double().abs()


def mlp_reference(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor, rtol: float = 2e-2, atol: float = 1e-3
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16 check's reference and limit, both (M, d) fp64: the MLP
    summed in fp64 with h and y rounded to bf16 as in the plain version,
    and ``atol + rtol |ref| + h_rounding_slack``.  Any correct summation
    order lies within the limit; :func:`reference_err` measures a result
    against it."""
    x64, g64, u64, d64 = (a.double() for a in (x, wg, wu, wd))
    g, u = x64 @ g64, x64 @ u64
    h = (F.silu(g) * u).to(x.dtype)
    ref = (h.double() @ d64).to(x.dtype).double()
    del h
    return ref, atol + rtol * ref.abs() + h_rounding_slack(x, wg, wu, wd,
                                                           g, u)


def reference_err(got: torch.Tensor, ref: torch.Tensor,
                  limit: torch.Tensor) -> float:
    """Worst |got - ref| / limit over the elements (<= 1: within)."""
    return ((got.double() - ref).abs() / limit).max().item()


def ffma_smem_bytes(bm: int, d: int) -> int:
    """The FFMA kernel's shared memory: x tile and partial y (bm x d each),
    the warps' partial g/u blocks and the h block, all fp32."""
    return 4 * (2 * bm * d + FFMA_WARPS * bm * FFMA_BF + FFMA_BF * bm)


def tc_takes(dtype: torch.dtype, d: int, ff: int, aligned: bool) -> bool:
    """Whether the tensor-core kernel takes these shapes: bf16, d and ff
    multiples of 8 (16-byte rows) and 16-byte aligned tensors.  Any d:
    past one cluster's TC_MAX_CLUSTER x TC_DS columns, clusters split d
    (:func:`tc_columns`)."""
    return (dtype == torch.bfloat16 and d % 8 == 0 and ff % 8 == 0
            and aligned)


def tc_clusters(d: int, ds: int = TC_DS) -> list[int]:
    """The cluster sizes the planner weighs for width d, largest first:
    ``ceil(nd / n)`` for n clusters splitting d's ``nd = ceil(d / ds)``
    column blocks (``ds``: TC_DS for the decode body, TP_DS for the
    prefill body), from the fewest clusters of at most TC_MAX_CLUSTER
    CTAs up to those of at most TC_PORTABLE.  One size, ``nd``, up to d
    2048 in the decode body."""
    nd = -(-d // ds)
    lo, hi = -(-nd // TC_MAX_CLUSTER), -(-nd // TC_PORTABLE)
    return sorted({-(-nd // n) for n in range(lo, hi + 1)}, reverse=True)


def tc_body(M: int, d: int) -> str:
    """The tensor-core kernel's body for M rows at width d, by
    :func:`mlp_plan`'s rule: "prefill" from PREFILL_ROWS rows on; "swap"
    up to SWAP_ROWS rows, and up to 64 past d SWAP_WIDE_D, wherever one
    cluster covers d (:func:`swap_clusters`); else "decode"."""
    if M >= PREFILL_ROWS:
        return "prefill"
    if swap_clusters(M, d) and (M <= SWAP_ROWS or d > SWAP_WIDE_D):
        return "swap"
    return "decode"


def swap_rows(M: int) -> int:
    """The swap body's wgmma N for M rows: M padded to 8, 16, 32 or 64 (0
    past 64: the body does not take it)."""
    return next((n for n in TS_ROWS if n >= M), 0)


def swap_max_tiles(M: int) -> int:
    """The most 64-column y tiles a rank of the swap body owns at M rows:
    each of its two consumer warpgroups holds half of them in N / 2 fp32
    registers a tile, 64 in all (0 past 64 rows)."""
    n = swap_rows(M)
    return min(TS_MAX_TILES, 256 // n) if n else 0


def swap_ds(d: int, cl: int) -> int:
    """y columns a rank of the swap body owns: whole 64-column tiles, d's
    ``ceil(d / 64)`` of them dealt ``ceil(tiles / cl)`` a rank."""
    return TS_TILE * -(-(-(-d // TS_TILE)) // cl)


def swap_clusters(M: int, d: int) -> list[int]:
    """The cluster sizes the swap body takes at (M, d), largest first:
    every cl up to TC_MAX_CLUSTER whose ranks' tiles cover d within
    :func:`swap_max_tiles`, each rank owning at least one (one cluster
    over all of d; empty where none does)."""
    most = swap_max_tiles(M)
    nt = -(-d // TS_TILE)
    return [cl for cl in range(TC_MAX_CLUSTER, 0, -1)
            if -(-nt // cl) <= most and (cl - 1) * -(-nt // cl) < nt]


def _swap_plan(M: int, d: int, ff: int, sizes: list[int],
               slots: Callable[[int], int]) -> tuple[int, int] | None:
    """(cl, S) of the swap body, in one wave: for each cl, S the fewest
    splits (at most a wave of clusters) that minimise rounds = ceil(ff
    blocks a split / cl); of the sizes, the least rounds x (d's up steps +
    the down steps of a round's cl blocks, ceil(T / 2) each), ties to the
    larger cl.  Fitted to every (cl, S) timed at the served decode shapes
    (``launch/gemm_timing.py --swap-grid``, PERF.md)."""
    n_blocks = -(-ff // TC_BF)
    n_up = -(-d // TC_BF)
    best = None
    for cl in sizes:
        wave = min(n_blocks, slots(cl))
        if wave <= 0:
            continue

        def rounds(S):
            return -(-(-(-n_blocks // S)) // cl)
        S = min(range(1, wave + 1), key=lambda S: (rounds(S), S))
        key = (rounds(S) * (n_up + cl * -(-(swap_ds(d, cl) // TS_TILE)
                                          // 2)), -cl)
        if best is None or key < best[0]:
            best = (key, cl, S)
    return None if best is None else best[1:]


def mlp_plan(M: int, d: int, ff: int, dtype: torch.dtype, aligned: bool,
             sms: int, path: str | None = None,
             slots: Callable[[int], int] | None = None,
             cl: int | None = None, body: str | None = None
             ) -> MlpPlan | None:
    """Choose the kernel, its body and its grid for an (M, d, ff) call.

    ``aligned``: all four tensors 16-byte aligned.  ``sms``: the device's
    SM count.  ``slots(cl)``: clusters of cl CTAs of the tensor-core
    kernel the device runs at once (default sms // cl - 1: one CTA an SM,
    and a cluster lives in one GPC; the occupancy calculator gives 15
    clusters of 8 on a 132-SM H100).  Every body takes one SM a CTA, so
    they run as many clusters of a size.
    ``path`` forces a kernel ("tc" raises where it does not take the
    shapes); by default bf16 calls that the tensor-core kernel takes go to
    it (decode too: it timed faster there than the FFMA kernel), the rest
    to the FFMA kernel.  ``body`` forces the tensor-core kernel's body and
    ``cl`` one of its sizes (:func:`tc_clusters`, :func:`swap_clusters`;
    for timing the others).  Returns None where the FFMA kernel cannot
    fit one row of d.

    tc, the body (:func:`tc_body`): "prefill" from PREFILL_ROWS (65) rows
    on, wherever the 64-row bodies need a second tile; below, "swap" up
    to SWAP_ROWS (32) rows at every width and up to 64 past d SWAP_WIDE_D
    (2048), wherever its one cluster covers d (up to d 4096 at 33-64
    rows); "decode" for the rest.  The rule is the card's
    (``launch/gemm_timing.py --sweep``, H100 SXM 700 W, the bodies forced
    by rows at every served width; PERF.md): the swap body is faster than
    the decode body at 1-32 rows at every width (qwen3 M 8 0.036 against
    0.042 ms, chameleon-34b 0.379 against 0.662), and at 33-64 rows past
    d 2048 where it takes them (chatglm3-6b M 64 0.135 against 0.143); at
    d 1152-2048 and 40-64 rows the two are within 2% at qwen3's and
    hymba's widths and the decode body is faster at gemma3's (M 64 0.0320
    against 0.0347).  Up to 64 rows the
    decode body is faster than the prefill body at every served width
    (one tile; the prefill body's 128-row tile is half padding); from 96
    rows the prefill body is faster at d 1600, 2048 and 4096 (not at
    gemma3's d 1152 below 256 rows, nor chatglm3's 192), and from 256
    rows at every width.

    swap: M padded to N = 8, 16, 32 or 64 rows (``bm``); one cluster of
    cl CTAs covers d, rank c owning y's 64-column tiles [T c, T (c + 1))
    for T = ceil(ceil(d / 64) / cl) (:func:`swap_ds`), at most
    :func:`swap_max_tiles` (cl from :func:`swap_clusters`); no h block is
    computed twice.  S, the ff splits, fills at most one wave of clusters
    (:func:`_swap_plan`).

    decode and prefill: a body's
    tiles are bm rows (TC_BM, TP_BM); a cluster of cl CTAs of ds columns
    (TC_DS, TP_DS), and n = ceil(d / (ds cl)) clusters splitting d, each
    computing its split's h again (cl from :func:`tc_clusters`).  For each
    cl: S = 1 where the n x M tiles' clusters fill a wave (y is stored
    directly, no workspace); else S, the ff splits, is the fewest that
    minimise waves x rounds, where waves = ceil(n x M tiles x S / clusters
    a wave) and rounds = ceil(ff blocks a split / cl).  Of the sizes, the
    least waves x rounds x (d's 64-deep up-projection steps + cl
    down-projection steps a round), ties to the larger cl (fewer FLOPs).

    ffma: the tallest row tile of 8, 4, 2, 1 whose shared memory fits,
    and S splits filling the SMs; its partials always go through the
    workspace.  S never exceeds the ff blocks."""
    n_blocks = -(-ff // TC_BF)
    tc_ok = tc_takes(dtype, d, ff, aligned)
    if path is None:
        path = "tc" if tc_ok else "ffma"
    if path == "tc":
        if not tc_ok:
            raise ValueError(f"linked_mlp: the tensor-core kernel does not "
                             f"take d={d}, ff={ff}, {dtype}, aligned="
                             f"{aligned}")
        if body is None:
            body = tc_body(M, d)
        if body not in ("decode", "swap", "prefill"):
            raise ValueError(f"linked_mlp: unknown body {body!r}")
        if body == "swap":
            sizes = swap_clusters(M, d)
            if not sizes:
                raise ValueError(f"linked_mlp: the swap body does not take "
                                 f"M={M}, d={d}")
            if cl is not None:
                if cl not in sizes:
                    raise ValueError(f"linked_mlp: d={d} at M={M} takes "
                                     f"swap clusters of {sizes} CTAs, not "
                                     f"{cl}")
                sizes = [cl]
            got = _swap_plan(M, d, ff, sizes, slots or (
                lambda cl: max(1, sms // cl - 1)))
            if got is None:
                raise ValueError(f"linked_mlp: this device runs no cluster "
                                 f"of {sizes} CTAs of the tensor-core "
                                 f"kernel's swap body")
            cl, S = got
            return MlpPlan("tc", swap_rows(M), cl, S, 8,
                           S * M * d if S > 1 else 0, "swap")
        bm, ds = (TP_BM, TP_DS) if body == "prefill" else (TC_BM, TC_DS)
        m_tiles = -(-M // bm)
        n_up = -(-d // TC_BF)
        sizes = tc_clusters(d, ds)
        if cl is not None:
            if cl not in sizes:
                raise ValueError(f"linked_mlp: d={d} splits over clusters "
                                 f"of {sizes} CTAs, not {cl}")
            sizes = [cl]
        best = None
        for cl in sizes:
            n = -(-(-(-d // ds)) // cl)
            wave = slots(cl) if slots is not None else max(1, sms // cl - 1)
            if wave <= 0:
                continue            # the device runs no cluster of cl

            def cost(S):
                return (-(-n * m_tiles * S // wave)
                        * -(-(-(-n_blocks // S)) // cl))
            S = 1 if n * m_tiles >= wave else min(
                range(1, n_blocks + 1), key=lambda S: (cost(S), S))
            key = cost(S) * (n_up + cl)
            if best is None or key < best[0]:
                best = (key, cl, S)
        if best is None:
            raise ValueError(f"linked_mlp: this device runs no cluster of "
                             f"{sizes} CTAs of the tensor-core kernel's "
                             f"{body} body")
        _, cl, S = best
        return MlpPlan("tc", bm, cl, S, 8, S * M * d if S > 1 else 0, body)
    if path != "ffma":
        raise ValueError(f"linked_mlp: unknown path {path!r}")
    bm = next((b for b in (8, 4, 2, 1)
               if ffma_smem_bytes(b, d) <= CTA_SMEM_MAX), 0)
    if bm == 0:
        return None
    vec = 16 // (4 if dtype == torch.float32 else 2)
    v = vec if aligned and d % vec == 0 and ff % vec == 0 else 2
    S = max(1, min(n_blocks, sms // -(-M // bm)))
    return MlpPlan("ffma", bm, 1, S, v, S * M * d, "ffma")


def split_blocks(n_blocks: int, S: int, s: int) -> tuple[int, int]:
    """The ff blocks ``[jb0, jb1)`` that split ``s`` of ``S`` walks: both
    kernels' formula.  The tensor-core kernel deals them to its cluster
    round robin: block jb goes to rank (jb - jb0) % cl in round
    (jb - jb0) // cl."""
    return s * n_blocks // S, (s + 1) * n_blocks // S


def tc_columns(d: int, cl: int, ds: int = TC_DS
               ) -> list[tuple[int, int, int, int]]:
    """The tensor-core kernel's ownership of y's columns: ``(cluster,
    rank, c0, c1)`` for every CTA along the grid's first axis.  CTA x
    (cluster x // cl, rank x % cl) owns ``[ds x, ds (x + 1))`` clipped to
    d (``ds``: TC_DS for the decode body, TP_DS for the prefill body,
    ``swap_ds(d, cl)`` for the swap body, whose one cluster owns all of
    d); the axis is ``ceil(d / ds)`` rounded up to whole clusters, so a
    last cluster's last CTAs may own nothing (``c0 == c1``)."""
    nd = -(-d // ds)
    gx = -(-nd // cl) * cl
    return [(x // cl, x % cl, min(d, ds * x), min(d, ds * (x + 1)))
            for x in range(gx)]


def _lib():
    lib = library("linked_mlp")
    if lib.repro_linked_mlp.argtypes is None:
        lib.repro_linked_mlp.argtypes = [ctypes.c_int] + \
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.repro_linked_mlp.restype = ctypes.c_int
        lib.repro_linked_mlp_tc.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.repro_linked_mlp_tc.restype = ctypes.c_int
        lib.repro_linked_mlp_tc_clusters.argtypes = [ctypes.c_int]
        lib.repro_linked_mlp_tc_clusters.restype = ctypes.c_int
        lib.repro_linked_mlp_tc_prefill.argtypes = \
            lib.repro_linked_mlp_tc.argtypes
        lib.repro_linked_mlp_tc_prefill.restype = ctypes.c_int
        lib.repro_linked_mlp_tc_swap.argtypes = \
            lib.repro_linked_mlp_tc.argtypes
        lib.repro_linked_mlp_tc_swap.restype = ctypes.c_int
    return lib


#: each tensor-core body's launch counter; its C entry point is the same
#: name after "repro_"
TC_COUNTER = {"decode": "linked_mlp_tc", "swap": "linked_mlp_tc_swap",
              "prefill": "linked_mlp_tc_prefill"}

_SLOTS: dict[tuple[int, int], int] = {}


def cluster_slots(device: torch.device) -> Callable[[int], int]:
    """``slots(cl)`` for ``device``: clusters of cl CTAs of the tensor-core
    kernel it runs at once, from the CUDA occupancy calculator (cached; 0
    where none fits, as a non-portable size may not)."""
    def slots(cl: int) -> int:
        key = (device.index, cl)
        n = _SLOTS.get(key)
        if n is None:
            with torch.cuda.device(device):
                n = _lib().repro_linked_mlp_tc_clusters(cl)
            if n < 0:
                raise RuntimeError(f"linked_mlp: the occupancy calculator "
                                   f"failed for clusters of {cl} CTAs")
            _SLOTS[key] = n
        return n
    return slots


@functools.lru_cache(maxsize=1024)
def _device_plan(index: int, M: int, d: int, ff: int, dtype: torch.dtype,
                 aligned: bool) -> MlpPlan | None:
    """:func:`mlp_plan` on CUDA device ``index``, once per shape, so that
    its search does not run again in every layer of every tick."""
    device = torch.device("cuda", index)
    return mlp_plan(M, d, ff, dtype, aligned, sm_count(device),
                    slots=cluster_slots(device))


def linked_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor, *, plan: MlpPlan | None = None
               ) -> torch.Tensor:
    """x (..., d); wg/wu (d, ff); wd (ff, d) -> (..., d) in x's dtype.  On
    CUDA all four must be contiguous, of one dtype (float32 or bfloat16),
    on one device.  ``plan`` overrides :func:`mlp_plan`'s choice (for
    tests and timing)."""
    refuse_grad("linked_mlp", x, wg, wu, wd)
    if not x.is_cuda:
        return linked_mlp_plain(x, wg, wu, wd)
    tensors = (x, wg, wu, wd)
    if any(not t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("linked_mlp: x, wg, wu and wd must lie on one CUDA "
                         "device")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype for t in tensors):
        raise ValueError("linked_mlp: x, wg, wu and wd must share float32 or "
                         f"bfloat16, got {x.dtype}/{wg.dtype}/{wu.dtype}/"
                         f"{wd.dtype}")
    d = x.shape[-1] if x.dim() else -1
    ff = wg.shape[1] if wg.dim() == 2 else -1
    if x.dim() < 1 or wg.shape != (d, ff) or wu.shape != (d, ff) \
            or wd.shape != (ff, d):
        raise ValueError("linked_mlp: want x (..., d), wg/wu (d, ff), wd "
                         f"(ff, d); got {tuple(x.shape)} {tuple(wg.shape)} "
                         f"{tuple(wu.shape)} {tuple(wd.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linked_mlp: x, wg, wu and wd must be contiguous")
    out = torch.empty_like(x)
    M = x.numel() // d if d > 0 else 0
    if M == 0 or d == 0 or ff == 0:
        return out.zero_()
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    if plan is None:
        plan = _device_plan(x.device.index, M, d, ff, x.dtype, aligned)
    if plan is None:
        raise ValueError(f"linked_mlp: d = {d} does not fit one row's x tile "
                         "and partial y in shared memory")
    part = torch.empty((plan.workspace,), dtype=torch.float32,
                       device=x.device) if plan.workspace else None
    part_ptr = part.data_ptr() if part is not None else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    if plan.path == "tc":
        fn = getattr(lib, "repro_" + TC_COUNTER[plan.body])
        err = fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                 part_ptr, out.data_ptr(), M, d, ff, plan.cl, plan.S, stream)
    else:
        err = lib.repro_linked_mlp(
            _DTYPE_CODE[x.dtype], x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
            wd.data_ptr(), part_ptr, out.data_ptr(), M, d, ff, plan.bm,
            plan.v, plan.S, stream)
    check_launch(err, "linked_mlp")
    count_launch("linked_mlp")
    if plan.path == "tc":
        count_launch(TC_COUNTER[plan.body])
    return out
