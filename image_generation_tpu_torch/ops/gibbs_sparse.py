"""The sparse field gather: colored block-Gibbs sweeps that read the
coupling only at the plan's edges.

One CUDA C++ kernel for Hopper takes every sweep of K1, K2 and K3 in every
value type: K1 with an f32 or bf16 dense coupling or a ``QuantCoupling``
(``ops/gibbs_cuda.py``), and the streaming route's modes
(``ops/gibbs_hbm_cuda.py``): K2 with a dense f32 or bf16 matrix or a
``QuantCoupling``, K3 with f32, bf16 or int8 ``BlockSparseCoupling``
panels.  It replaces ``image_generation_tpu/ops/gibbs_pallas.py``
(``_kernel``, ``_kernel_fed`` and ``_color_update``) and
``gibbs_pallas_hbm.py`` (``_kernel`` / ``_kernel_bs``), and computes what
they compute: int8 in their quantized units (h / scale, β · scale, ΔE ×
scale), f32 and bf16 as f32 sums of the exact value × ±1 products.  The
source is ``csrc/gibbs_sparse.cu``; its header note says what bounds it
on the H100 (not the bytes but the work of each (column, chain) update
and one barrier a pass over a color class) and how the design meets
that.  ``ops/cuda_build.py`` builds it beside K4; it is bound here
with ``ctypes``.

The kernel reads the coupling only at its nonzeros, through a static
neighbour table per plan (``neighbor_table``): for each padded column, its
neighbours' spin positions and the offsets of their couplings in the
coupling as it is stored (dense or packed panels).  The table holds no
values: every launch first gathers the coupling's current values into one
word a slot (``table_words`` is the plain version of that pass): 4 bytes
for int8 and bf16, 8 for f32.  This relies on a contract the sampler model
keeps: **the coupling is zero off the plan's edges** (``permuted_model`` /
``permuted_model_rows`` write couplings only there, and the bf16 cast,
``quantize_coupling`` and ``pack_coupling`` keep zeros zero).  A coupling
with other nonzeros is sampled as if they were zero.

The kernel sweeps only the live columns of each class span
(``live_spans``): ``build_plan`` rounds every block up to 128 columns,
and that padding, with no coupling and nothing reading it, is drawn once,
in the last sweep, with the same outputs bit for bit.

``gibbs_sweeps_sparse`` is the wrapper, called by the two routes'
wrappers; it adds one to the counter and mode name they pass where it
launches the kernel, and the columns it updates to
``gibbs_sweeps_sparse.columns`` (``"live"``: swept every sweep;
``"padding"``: drawn once; each times chains and sweeps).  For a tensor
on the CPU it runs the plain version,
``gibbs_sweeps_sparse_reference`` (the same words, fields summed per class
span in the kernel's slot order: exact int32 for int8, f32 for f32 and
bf16, so the kernel's fields equal it bit for bit); for a CUDA tensor it
launches the kernel or raises.  ``launch_shape`` is the rule for the
chains per thread block and the threads.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from image_generation_tpu_torch.ops.block_sparse import BlockSparseCoupling, panel_offset
from image_generation_tpu_torch.ops.cuda_build import KernelLibrary, load_libraries
from image_generation_tpu_torch.ops.gibbs import GibbsPlan, class_spans
from image_generation_tpu_torch.ops.quant import QuantCoupling

__all__ = [
    "neighbor_table",
    "live_spans",
    "table_words",
    "launch_shape",
    "supported",
    "gibbs_sweeps_sparse",
    "gibbs_sweeps_sparse_reference",
    "load_library",
]

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_STATIC_SMEM = 32 * 16 * 4  # the energy carry's per-warp partial sums (G ≤ 16)
_SMS = 132  # streaming multiprocessors of an H100 SXM: launch_shape's default
_CHAINS = (16, 8, 4, 2, 1)  # chains per thread block the source instantiates
# live columns beyond which one chain a block keeps a 512-thread block busy (launch_shape)
_WIDE_SPAN = 512
# stored value type -> (code of the C entry, bits of the value in a table
# word, the widest n_pad whose spin positions fit the word's other bits,
# bytes of the word)
_VALUES = {torch.int8: (0, 8, (1 << 23) - 1, 4), torch.bfloat16: (1, 16, 1 << 16, 4),
           torch.float32: (2, 32, (1 << 31) - 1, 8)}

_library: Optional[KernelLibrary] = None
_library_lock = threading.Lock()


def load_library() -> KernelLibrary:
    """Build (once per source hash, with the other kernels) and load the
    gather kernel's library."""
    global _library
    with _library_lock:
        if _library is not None:
            return _library
        built = load_libraries()["gibbs_sparse"]
        lib = built.lib
        lib.gibbs_sparse.argtypes = [
            ctypes.c_int,  # dtype: 0 int8, 1 bf16, 2 f32
            ctypes.c_void_p,  # coupling (dense or panels)
            ctypes.c_void_p,  # nbr (deg, n_pad) int32
            ctypes.c_void_p,  # off (deg, n_pad) int32
            ctypes.c_void_p,  # entry scratch (deg, n_pad) words
            ctypes.c_int,  # deg
            ctypes.c_void_p,  # spins_in
            ctypes.c_void_p,  # spins_out
            ctypes.c_void_p,  # h (int8: / scale)
            ctypes.c_void_p,  # beta (int8: · scale)
            ctypes.c_void_p,  # uniforms (null: Philox)
            ctypes.c_void_p,  # seed (null: fed)
            ctypes.c_void_p,  # delta_e (null: no energy carry)
            ctypes.c_void_p,  # spans (c0, c1) int32
            ctypes.c_int,  # n_spans
            ctypes.c_int,  # n_chains
            ctypes.c_int,  # n_pad
            ctypes.c_int,  # n_sweeps
            ctypes.c_int,  # chains_per_block
            ctypes.c_int,  # threads
            ctypes.c_void_p,  # stream
        ]
        lib.gibbs_sparse.restype = ctypes.c_int
        lib.gibbs_sparse_error_string.argtypes = [ctypes.c_int]
        lib.gibbs_sparse_error_string.restype = ctypes.c_char_p
        lib.gibbs_sparse_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gibbs_sparse_smem_bytes.restype = ctypes.c_longlong
        lib.gibbs_sparse_max_n_pad.argtypes = [ctypes.c_int]
        lib.gibbs_sparse_max_n_pad.restype = ctypes.c_int
        lib.gibbs_sparse_word_bytes.argtypes = [ctypes.c_int]
        lib.gibbs_sparse_word_bytes.restype = ctypes.c_int
        for g in _CHAINS:
            if lib.gibbs_sparse_smem_bytes(g, 6016) != _dynamic_smem(g, 6016):
                raise RuntimeError("kernel library and wrapper disagree on shared memory")
        for code, _bits, widest, word in _VALUES.values():
            if (lib.gibbs_sparse_max_n_pad(code) != widest
                    or lib.gibbs_sparse_word_bytes(code) != word):
                raise RuntimeError("kernel library and wrapper disagree on the table word")
        _library = built
        return _library


# ---------------------------------------------------------------------------
# the neighbour table
# ---------------------------------------------------------------------------

def neighbor_table(plan: GibbsPlan, chunk: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(nbr, off): two (deg, n_pad) int32 arrays, deg the plan's largest
    degree.  Slot d of padded column c lists c's d-th neighbour k (in
    ascending order) and the offset of A[k, c] in the coupling as it is
    stored: ``k·n_pad + c`` in a dense (n_pad, n_pad) matrix (``chunk``
    None), or ``block_sparse.panel_offset`` in ``pack_coupling(plan, ·,
    chunk)``'s panels, whatever the value type.  Empty slots (and every
    slot of a padding column) hold nbr 0 and off −1.  Built from the plan's edge list in both directions, each
    pair once; raises if an edge joins two columns of one color-class span
    (the kernel updates a span at once, in place)."""
    n_pad = plan.n_pad
    ei = np.asarray(plan.perm_edge_i, np.int64)
    ej = np.asarray(plan.perm_edge_j, np.int64)
    pairs = np.unique(np.concatenate([ei * n_pad + ej, ej * n_pad + ei]))
    k, c = pairs // n_pad, pairs % n_pad  # A[k, c]: neighbour k of column c
    span_of = np.zeros(n_pad, np.int64)
    for s, (c0, c1, _b0, _b1) in enumerate(class_spans(plan)):
        span_of[c0:c1] = s
    if np.any(span_of[k] == span_of[c]):
        raise ValueError("the plan couples two columns of one color-class span; "
                         "the gather sweep kernel updates a span at once")
    order = np.lexsort((k, c))
    k, c = k[order], c[order]
    counts = np.bincount(c, minlength=n_pad)
    deg = max(1, int(counts.max()) if len(c) else 0)
    slot = np.arange(len(c)) - np.repeat(np.cumsum(counts) - counts, counts)
    offsets = k * n_pad + c if chunk is None else panel_offset(plan, chunk, k, c)
    if offsets.size and offsets.max() >= 2**31:
        raise ValueError("the coupling is too large for int32 offsets")
    nbr = np.zeros((deg, n_pad), np.int32)
    off = np.full((deg, n_pad), -1, np.int32)
    nbr[slot, c] = k
    off[slot, c] = offsets
    return nbr, off


_live_spans_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def live_spans(plan: GibbsPlan) -> Tuple[Tuple[int, int, int], ...]:
    """(c0, live_stop, c1) for each color-class span of ``class_spans``:
    the kernel updates [c0, live_stop) every sweep and the padding
    [live_stop, c1) only in the last.  live_stop is the valid stop of the
    span's last block where that block alone has padding and no edge
    touches it, as in every plan ``build_plan`` makes; otherwise (padding
    inside a span, or coupled) c1, and the whole span sweeps."""
    cached = _live_spans_cache.get(plan)
    if cached is not None:
        return cached
    touched = np.zeros(plan.n_pad, bool)
    touched[np.asarray(plan.perm_edge_i, np.int64)] = True
    touched[np.asarray(plan.perm_edge_j, np.int64)] = True
    out = []
    for c0, c1, b0, b1 in class_spans(plan):
        stop = plan.blocks[b1 - 1][1]
        if any(v != e for _s, v, e in plan.blocks[b0:b1 - 1]) or touched[stop:c1].any():
            stop = c1
        out.append((c0, stop, c1))
    _live_spans_cache[plan] = tuple(out)
    return _live_spans_cache[plan]


_table_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _device_table(plan: GibbsPlan, chunk: Optional[int], device):
    """(nbr, off, spans, (live, padding)) on ``device``, built once per
    (plan, chunk, device): spans is the (n_spans, 3) int32 of
    ``live_spans``; live and padding count its swept and once-drawn
    columns."""
    per_plan = _table_cache.setdefault(plan, {})
    key = (chunk, str(device))
    if key not in per_plan:
        nbr, off = neighbor_table(plan, chunk)
        spans = live_spans(plan)
        live = sum(stop - c0 for c0, stop, _c1 in spans)
        per_plan[key] = (torch.from_numpy(nbr).to(device), torch.from_numpy(off).to(device),
                         torch.tensor(spans, dtype=torch.int32, device=device),
                         (live, plan.n_pad - live))
    return per_plan[key]


def _stored(coupling_p, plan: GibbsPlan):
    """(flat stored coupling, scale or None, chunk or None) of a
    ``QuantCoupling``, a dense f32 or bf16 (n_pad, n_pad) matrix, or int8
    (with their scale), bf16 or f32 ``BlockSparseCoupling`` panels."""
    if isinstance(coupling_p, BlockSparseCoupling):
        if coupling_p.plan is not plan:
            raise ValueError("the packed coupling was cut for another plan")
        dtype = coupling_p.panels.dtype
        if coupling_p.quantized and dtype == torch.int8:
            return coupling_p.panels, coupling_p.scale, coupling_p.chunk
        if not coupling_p.quantized and dtype in (torch.bfloat16, torch.float32):
            return coupling_p.panels, None, coupling_p.chunk
        raise TypeError(f"the gather sweep takes int8 panels with their scale or bf16 or f32 "
                        f"panels, got {dtype} panels")
    if isinstance(coupling_p, QuantCoupling) and coupling_p.q.dtype == torch.int8:
        mat, scale = coupling_p.q, coupling_p.scale
    elif (isinstance(coupling_p, torch.Tensor)
          and coupling_p.dtype in (torch.float32, torch.bfloat16)):
        mat, scale = coupling_p, None
    else:
        what = (f"a {coupling_p.dtype} tensor" if isinstance(coupling_p, torch.Tensor)
                else type(coupling_p).__name__)
        raise TypeError(f"the gather sweep takes a QuantCoupling, an f32 or bf16 matrix or "
                        f"int8 / bf16 / f32 panels, got {what}")
    if tuple(mat.shape) != (plan.n_pad, plan.n_pad):
        raise ValueError(f"the coupling must be ({plan.n_pad}, {plan.n_pad}), "
                         f"got {tuple(mat.shape)}")
    return mat, scale, None


def _check_word(dtype, n_pad: int) -> None:
    if n_pad > _VALUES[dtype][2]:
        raise ValueError(f"n_pad={n_pad} is wider than a {dtype} table word holds "
                         f"(n_pad <= {_VALUES[dtype][2]})")


def table_words(coupling_p, plan: GibbsPlan) -> torch.Tensor:
    """The (deg, n_pad) table the kernel's first pass gathers, as int64
    holding each unsigned word: ``(k << 8) | (A[k, c] & 0xff)`` for int8,
    ``(k << 16) | bf16 bits of A[k, c]`` for bf16, ``(k << 32) | f32 bits``
    for f32 (the kernel's {k, f32 bits} pair, read as one little-endian
    64-bit word), 0 for an empty slot; on the coupling's device.  Raises
    on a plan wider than the word holds (n_pad above 2²³ − 1 for int8, 2¹⁶
    for bf16, 2³¹ − 1 for f32)."""
    mat, _scale, chunk = _stored(coupling_p, plan)
    _check_word(mat.dtype, plan.n_pad)
    nbr, off, _spans, _columns = _device_table(plan, chunk, mat.device)
    vals = mat.reshape(-1)[off.clamp(min=0).long()]
    if mat.dtype == torch.int8:
        bits = vals.long() & 0xFF
    elif mat.dtype == torch.bfloat16:
        bits = vals.view(torch.int16).long() & 0xFFFF
    else:
        bits = vals.view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(off >= 0, (nbr.long() << _VALUES[mat.dtype][1]) | bits, 0)


def _word_values(words: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neighbour positions int64, values: int32 for int8, f32 for f32 and
    bf16) of ``table_words``' words, decoded as the kernel decodes them."""
    bits = _VALUES[dtype][1]
    low = words & ((1 << bits) - 1)
    if dtype == torch.int8:
        vals = (low - ((low >> 7) << 8)).to(torch.int32)  # sign of the low byte
    else:
        # f32: the low word; bf16: its bits as the high half of an f32
        f32_bits = low if dtype == torch.float32 else low << 16
        vals = torch.where(f32_bits >= 2**31, f32_bits - 2**32, f32_bits).to(
            torch.int32).view(torch.float32)
    return words >> bits, vals


def span_sums(s_acc: torch.Tensor, nbr: torch.Tensor, vals: torch.Tensor, c0: int,
              c1: int) -> torch.Tensor:
    """(chains, c1 − c0) sums over the table's slots, in slot order, of
    vals[d, c] · s[:, nbr[d, c]] for the columns [c0, c1): the fields
    before h, as the kernel sums them (``_word_values`` gives nbr and
    vals; ``s_acc`` is the spins in the values' type)."""
    acc = torch.zeros((s_acc.shape[0], c1 - c0), dtype=vals.dtype, device=s_acc.device)
    for d in range(nbr.shape[0]):
        acc += s_acc[:, nbr[d, c0:c1]] * vals[d, c0:c1]
    return acc


# ---------------------------------------------------------------------------
# the launch shape
# ---------------------------------------------------------------------------

def _dynamic_smem(chains_per_block: int, n_pad: int) -> int:
    """``smem_bytes`` in the source: the block's spins as int8."""
    return chains_per_block * n_pad


def _fits(chains_per_block: int, n_pad: int) -> bool:
    return _dynamic_smem(chains_per_block, n_pad) + _STATIC_SMEM <= _SMEM_LIMIT


def _threads(chains_per_block: int, widest: int) -> int:
    """Threads per block: 512 for one chain a block, and for more where a
    pass of 512 (column, chain) pairs still covers the plan's widest live
    span (``widest`` columns; G = 2 and 4 on the flagship plans, whose
    live spans are at most 72 wide); else 1,024, two blocks an SM.

    Measured on an NVIDIA H100 80GB HBM3 (700 W), device time over every G
    at 512 and 1,024 threads on the served plan at 256·k chains x 80
    sweeps, k = 1 to 16, two runs each: at G = 2 and 4, 1,024
    threads idle at least three quarters of their warps at every barrier
    (a pass is 256 or 512 columns, a live span 72 at most), and 512 were
    10 to 13 % faster at the G ``launch_shape`` picks (k = 2 and 4); at
    G = 8 and 16, 512 threads take two passes over the widest spans, and
    1,024 were as fast or faster.  On the 2,048-latent and scaled plans
    (spans up to 512 and 1,408 columns) every G of two or more takes
    1,024, within 9 % of the fastest shape at 256, 1,024 and 2,048 chains
    (``chip_smoke.py`` phases 6, 11 and 21; PERF.md)."""
    return 512 if chains_per_block == 1 or 512 // chains_per_block >= widest else 1024


def launch_shape(plan: GibbsPlan, n_chains: int, sms: int = _SMS) -> Tuple[int, int]:
    """(chains per thread block G, threads per block).  On a plan whose
    widest live span is wider than ``_WIDE_SPAN`` columns, G = 1 at any
    chain count.  Otherwise the largest G whose grid still makes one full
    wave of blocks on ``sms`` SMs (the wrapper passes its card's count)
    and whose spins fit shared memory (the largest that fits otherwise; G
    0 when none does): on an H100's 132 SMs, 256 chains take G = 1 (256
    blocks), 1,024 G = 4, 2,048 G = 8.  The threads follow the widest live
    span (``_threads``).

    Measured on an NVIDIA H100 80GB HBM3 (700 W), device time a launch of
    256·k chains x 80 sweeps, every (G, threads) at k = 1 to 16: on the
    scaled plan (int8 panels, live spans up to 1,407 columns) one chain a
    block at 512 threads was the fastest shape or within 1.7 % of it at
    every k, and its time grows with the chains (2.12 ms at k = 1, 1.68 to
    1.73 ms a further 256 chains, 27.52 at k = 16), where the wave rule's
    G = 16 took 28.5 ms at every k from 9 to 16 (PERF.md §6).  On the
    flagship plans (spans up to 72 columns) one chain a block leaves most
    threads idle, and the wave rule stays."""
    widest = max(stop - c0 for c0, stop, _c1 in live_spans(plan))
    if widest > _WIDE_SPAN and _fits(1, plan.n_pad):
        return 1, _threads(1, widest)
    fits = [g for g in _CHAINS if _fits(g, plan.n_pad)]
    for g in fits:
        if -(-n_chains // g) >= sms:
            return g, _threads(g, widest)
    g = fits[-1] if fits else 0
    return g, _threads(g, widest)


def supported(plan: GibbsPlan, n_chains: int, dtype=torch.int8) -> bool:
    """Whether the kernel takes this problem with a coupling stored as
    ``dtype`` (int8, bf16 or f32; K1's gate): one chain's spins fit shared
    memory and a table word holds a spin position."""
    return (n_chains >= 1 and plan.n_pad <= _VALUES[dtype][2]
            and launch_shape(plan, n_chains)[0] > 0)


# ---------------------------------------------------------------------------
# the wrapper and its plain version
# ---------------------------------------------------------------------------

def gibbs_sweeps_sparse_reference(
    hp: torch.Tensor,
    coupling_p,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    n_sweeps: int,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    track_delta_e: bool = False,
):
    """The plain PyTorch version of the kernel, with its table words: per
    sweep, per color-class span of ``class_spans(plan)``, fields = the sum
    over the table's slots, in slot order, of A[k, c] · s[k] (decoded from
    ``table_words``) + h: int8 in int32 and in quantized units (h / scale,
    β · scale, ΔE × scale at the end), f32 and bf16 in f32 (each product
    exact).
    Then the sigmoid, the draw and ΔE as ``gibbs_sweeps_kernel_reference``
    computes them (per block of the span: uniforms drawn from
    ``generator`` block by block in plan order, ΔE summed block by block).

    ``coupling_p``: a ``QuantCoupling``, a dense f32 or bf16 matrix, or
    int8 / bf16 / f32 ``BlockSparseCoupling`` panels; ``uniforms``: at least
    ``n_sweeps`` rows of (chains, n_pad), read at [sweep, row, column].
    Returns new f32 spins, or (spins, delta_e)."""
    chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    mat, scale, _chunk = _stored(coupling_p, plan)
    dev = spins_p.device
    nbr, vals = _word_values(table_words(coupling_p, plan).to(dev), mat.dtype)
    quant = scale is not None
    beta_col = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    if quant:
        hp, beta_col = hp / scale, beta_col * scale
    beta_col = beta_col.reshape(-1, 1) if beta_col.ndim else beta_col
    s = spins_p.to(torch.float32).clone()
    s_acc = s.to(torch.int32) if quant else s  # the spins in the accumulator's type
    de = torch.zeros(chains, dtype=torch.float32, device=dev)
    gdev = generator.device if generator is not None else dev
    for sweep in range(n_sweeps):
        for c0, c1, b0, b1 in class_spans(plan):
            fields = span_sums(s_acc, nbr, vals, c0, c1).to(torch.float32) + hp[c0:c1]
            p_plus = torch.sigmoid(-2.0 * beta_col * fields)
            if uniforms is not None:
                u = uniforms[sweep, :, c0:c1]
            else:
                u = torch.cat([torch.rand((chains, e - s0), generator=generator, device=gdev).to(dev)
                               for s0, _v, e in plan.blocks[b0:b1]], 1)
            new = torch.where(u < p_plus, 1.0, -1.0)
            if track_delta_e:
                for s0, _v, e in plan.blocks[b0:b1]:
                    de = de + (fields[:, s0 - c0 : e - c0]
                               * (new[:, s0 - c0 : e - c0] - s[:, s0:e])).sum(-1)
            s[:, c0:c1] = new
            if quant:
                s_acc[:, c0:c1] = new.to(torch.int32)
    if not track_delta_e:
        return s
    return s, (de * scale if quant else de)


def gibbs_sweeps_sparse(
    hp: torch.Tensor,
    coupling_p,
    plan: GibbsPlan,
    spins_p: torch.Tensor,
    n_sweeps: int,
    beta=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
    track_delta_e: bool = False,
    count: Optional[Tuple[collections.Counter, str]] = None,
    _shape: Optional[Tuple[int, int]] = None,
):
    """``n_sweeps`` colored block-Gibbs sweeps through the sparse gather
    kernel, with an int8 coupling (a ``QuantCoupling``, or int8
    ``BlockSparseCoupling`` panels), a bf16 or an f32 one (a dense
    (n_pad, n_pad) matrix, or panels).

    ``hp`` (n_pad,) and ``spins_p`` (chains, n_pad) f32, ``beta`` scalar
    or (chains,); optional fed ``uniforms`` (>= n_sweeps, chains, n_pad)
    f32, else the kernel draws from K1's Philox stream keyed by a seed
    drawn from ``generator``.  Returns new f32 spins, or (spins, delta_e)
    with ``track_delta_e`` (int8: rescaled to the coupling's units).  A CPU
    ``spins_p`` runs the plain version; a CUDA one launches the kernel, and
    anything it does not take raises (a plan wider than the table word, a
    shape that does not fit).  ``count`` = (counter, mode name): the launch
    adds one there, and its live and padding columns times chains times
    sweeps to ``gibbs_sweeps_sparse.columns``.  ``_shape`` overrides
    ``launch_shape`` (chains per block, threads) for measuring the kernel.

    The kernel draws each span's padding (``live_spans``) once, with field
    h, so its share of ΔE is h · (final − initial spin): zero for every
    caller here, since ``permuted_model`` and ``permuted_model_rows``
    hold h at zero on padding."""
    if spins_p.device.type == "cpu":
        return gibbs_sweeps_sparse_reference(
            hp, coupling_p, plan, spins_p, n_sweeps, beta,
            generator=generator, uniforms=uniforms, track_delta_e=track_delta_e,
        )
    if spins_p.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {spins_p.device}")
    from image_generation_tpu_torch.ops.gibbs_cuda import _check, draw_seed

    dev = spins_p.device
    n_chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    mat, scale, chunk = _stored(coupling_p, plan)
    _check_word(mat.dtype, n_pad)
    _check("spins_p", spins_p, (n_chains, n_pad), dev)
    _check("coupling", mat, tuple(mat.shape), dev, mat.dtype)
    _check("hp", hp, (n_pad,), dev)
    g, threads = _shape or launch_shape(
        plan, n_chains, torch.cuda.get_device_properties(dev).multi_processor_count)
    if (g not in _CHAINS or not _fits(g, n_pad)
            or threads % 32 or threads % g or not 32 <= threads <= 1024):
        raise ValueError(f"{g} chains of n_pad={n_pad} a block at {threads} threads do not "
                         f"fit the gather sweep kernel")
    nbr, off, spans, (live, padding) = _device_table(plan, chunk, dev)
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    if beta_t.ndim == 0:
        beta_t = beta_t.expand(n_chains)
    if scale is not None:  # quantized units, computed on the device (no host sync)
        hp, beta_t = hp / scale, beta_t * scale
    beta_t = beta_t.contiguous()
    _check("beta", beta_t, (n_chains,), dev)
    if uniforms is not None:
        if uniforms.shape[0] < n_sweeps:
            raise ValueError(f"uniforms need {n_sweeps} sweeps, got {uniforms.shape[0]}")
        _check("uniforms", uniforms, (uniforms.shape[0], n_chains, n_pad), dev)
        seed = None
    else:
        seed = draw_seed(generator, dev)
    out = torch.empty_like(spins_p)
    # the words' scratch, in 32-bit units: one a slot (int8, bf16) or two (f32)
    entry = torch.empty((*nbr.shape, _VALUES[mat.dtype][3] // 4), dtype=torch.int32, device=dev)
    delta_e = torch.empty(n_chains, dtype=torch.float32, device=dev) if track_delta_e else None
    lib = load_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gibbs_sparse(
            _VALUES[mat.dtype][0], mat.data_ptr(), nbr.data_ptr(), off.data_ptr(),
            entry.data_ptr(), nbr.shape[0], spins_p.data_ptr(), out.data_ptr(),
            hp.data_ptr(), beta_t.data_ptr(),
            uniforms.data_ptr() if uniforms is not None else None,
            seed.data_ptr() if seed is not None else None,
            delta_e.data_ptr() if delta_e is not None else None,
            spans.data_ptr(), spans.shape[0], n_chains, n_pad, int(n_sweeps), g, threads, stream,
        )
    if err != 0:
        msg = lib.gibbs_sparse_error_string(err).decode()
        raise RuntimeError(f"gibbs_sparse launch failed: {msg} ({err})")
    if count is not None:
        count[0][count[1]] += 1
    gibbs_sweeps_sparse.columns["live"] += live * n_chains * int(n_sweeps)
    gibbs_sweeps_sparse.columns["padding"] += padding * n_chains * int(n_sweeps)
    if not track_delta_e:
        return out
    return out, (delta_e * scale if scale is not None else delta_e)


gibbs_sweeps_sparse.columns = collections.Counter()
