"""The int8 sweep kernel: colored block-Gibbs as a sparse field gather.

One CUDA C++ kernel for Hopper takes every int8 sweep of the port: K1's
int8 mode (a ``QuantCoupling`` on the K1 route, ``ops/gibbs_cuda.py``) and
K2's and K3's (a ``QuantCoupling`` or int8 ``BlockSparseCoupling`` panels
on the streaming route, ``ops/gibbs_hbm_cuda.py``).  It replaces the int8
modes of ``image_generation_tpu/ops/gibbs_pallas.py`` (``_color_update``
with a ``QuantCoupling``) and ``gibbs_pallas_hbm.py`` (``_kernel`` /
``_kernel_bs`` with int8 panels), and computes what they compute, in their
quantized units (h / scale, β · scale, ΔE × scale).  The source is
``csrc/gibbs_sparse_int8.cu``; its header note says what bounds it on the
H100 and how the design meets that.  ``ops/cuda_build.py`` builds it beside
the other kernels; it is bound here with ``ctypes``.

The kernel reads the coupling only at its nonzeros, through a static
neighbour table per plan (``neighbor_table``): for each padded column, its
neighbours' spin positions and the offsets of their couplings in the
coupling as it is stored (dense or packed panels).  This relies on a
contract the sampler model keeps: **the coupling is zero off the plan's
edges** (``permuted_model`` / ``permuted_model_rows`` write couplings only
there, and ``quantize_coupling`` and ``pack_coupling`` keep zeros zero).
A coupling with other nonzeros is sampled as if they were zero.

``gibbs_sweeps_sparse_int8`` is the wrapper, called by the two routes'
wrappers; it adds one to the counter and mode name they pass where it
launches the kernel.  For a tensor
on the CPU it runs the plain version, ``gibbs_sweeps_sparse_int8_reference``
(the same table, fields gathered and summed in int32 per class span); for
a CUDA tensor it launches the kernel or raises.  ``launch_shape`` is the
rule for the chains per thread block and the threads.
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
    "launch_shape",
    "supported",
    "gibbs_sweeps_sparse_int8",
    "gibbs_sweeps_sparse_int8_reference",
    "load_library",
]

_SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use
_STATIC_SMEM = 32 * 16 * 4  # the energy carry's per-warp partial sums (G ≤ 16)
_SMS = 132  # streaming multiprocessors of an H100 SXM: launch_shape's default
_CHAINS = (16, 8, 4, 2, 1)  # chains per thread block the source instantiates
_MAX_N_PAD = 1 << 23  # a gathered table word holds the neighbour in 24 bits

_library: Optional[KernelLibrary] = None
_library_lock = threading.Lock()


def load_library() -> KernelLibrary:
    """Build (once per source hash, with the other kernels) and load the
    int8 gather kernel's library."""
    global _library
    with _library_lock:
        if _library is not None:
            return _library
        built = load_libraries()["gibbs_sparse_int8"]
        lib = built.lib
        lib.gibbs_sparse_int8.argtypes = [
            ctypes.c_void_p,  # coupling (int8, dense or panels)
            ctypes.c_void_p,  # nbr (deg, n_pad) int32
            ctypes.c_void_p,  # off (deg, n_pad) int32
            ctypes.c_void_p,  # entry scratch (deg, n_pad) int32
            ctypes.c_int,  # deg
            ctypes.c_void_p,  # spins_in
            ctypes.c_void_p,  # spins_out
            ctypes.c_void_p,  # h / scale
            ctypes.c_void_p,  # beta · scale
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
        lib.gibbs_sparse_int8.restype = ctypes.c_int
        lib.gibbs_sparse_int8_error_string.argtypes = [ctypes.c_int]
        lib.gibbs_sparse_int8_error_string.restype = ctypes.c_char_p
        lib.gibbs_sparse_int8_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gibbs_sparse_int8_smem_bytes.restype = ctypes.c_longlong
        for g in _CHAINS:
            if lib.gibbs_sparse_int8_smem_bytes(g, 6016) != _dynamic_smem(g, 6016):
                raise RuntimeError("kernel library and wrapper disagree on shared memory")
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
    chunk)``'s panels.  Empty slots (and every slot of a padding column) hold nbr 0
    and off −1.  Built from the plan's edge list in both directions, each
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
                         "the int8 sweep kernel updates a span at once")
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


_table_cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _device_table(plan: GibbsPlan, chunk: Optional[int], device):
    """(nbr, off, spans) on ``device``, built once per (plan, chunk,
    device): spans is the (n_spans, 2) int32 (c0, c1) of ``class_spans``."""
    per_plan = _table_cache.setdefault(plan, {})
    key = (chunk, str(device))
    if key not in per_plan:
        nbr, off = neighbor_table(plan, chunk)
        spans = [(c0, c1) for c0, c1, _b0, _b1 in class_spans(plan)]
        per_plan[key] = (torch.from_numpy(nbr).to(device), torch.from_numpy(off).to(device),
                         torch.tensor(spans, dtype=torch.int32, device=device))
    return per_plan[key]


# ---------------------------------------------------------------------------
# the launch shape
# ---------------------------------------------------------------------------

def _dynamic_smem(chains_per_block: int, n_pad: int) -> int:
    """``smem_bytes`` in the source: the block's spins as int8."""
    return chains_per_block * n_pad


def _fits(chains_per_block: int, n_pad: int) -> bool:
    return _dynamic_smem(chains_per_block, n_pad) + _STATIC_SMEM <= _SMEM_LIMIT


def _threads(chains_per_block: int) -> int:
    """Threads per block: 512 (column, chain) pairs a pass for one chain a
    block, 1,024 for more.  Measured on an H100 SXM (700 W) over every G
    at 512 and 1,024 threads, at 256, 1,024 and 2,048 chains on the
    2,048-latent and scaled plans, three runs: with the G of
    ``launch_shape`` these were within 9 % of the fastest shape in each
    case (PERF.md)."""
    return 512 if chains_per_block == 1 else 1024


def launch_shape(plan: GibbsPlan, n_chains: int, sms: int = _SMS) -> Tuple[int, int]:
    """(chains per thread block G, threads per block): the largest G whose
    grid still makes one full wave of blocks on ``sms`` SMs (the wrapper
    passes its card's count) and whose spins fit shared memory (the
    largest that fits otherwise; G 0 when none does).  On an H100's 132
    SMs, 256 chains take G = 1 (256 blocks), 1,024 G = 4, 2,048 G = 8."""
    fits = [g for g in _CHAINS if _fits(g, plan.n_pad)]
    for g in fits:
        if -(-n_chains // g) >= sms:
            return g, _threads(g)
    g = fits[-1] if fits else 0
    return g, _threads(g)


def supported(plan: GibbsPlan, n_chains: int) -> bool:
    """Whether the kernel takes this problem: one chain's spins fit shared
    memory and a table word holds a spin position."""
    return n_chains >= 1 and plan.n_pad < _MAX_N_PAD and launch_shape(plan, n_chains)[0] > 0


# ---------------------------------------------------------------------------
# the wrapper and its plain version
# ---------------------------------------------------------------------------

def _stored(coupling_p, plan: GibbsPlan):
    """(flat int8 stored coupling, scale, chunk or None) of a
    ``QuantCoupling`` or int8 ``BlockSparseCoupling``."""
    if isinstance(coupling_p, BlockSparseCoupling):
        if not coupling_p.quantized or coupling_p.panels.dtype != torch.int8:
            raise TypeError("the int8 sweep takes int8 panels with their scale")
        if coupling_p.plan is not plan:
            raise ValueError("the packed coupling was cut for another plan")
        return coupling_p.panels, coupling_p.scale, coupling_p.chunk
    if not isinstance(coupling_p, QuantCoupling) or coupling_p.q.dtype != torch.int8:
        raise TypeError(f"the int8 sweep takes a QuantCoupling or int8 panels, "
                        f"got {type(coupling_p).__name__}")
    if tuple(coupling_p.q.shape) != (plan.n_pad, plan.n_pad):
        raise ValueError(f"the coupling must be ({plan.n_pad}, {plan.n_pad}), "
                         f"got {tuple(coupling_p.q.shape)}")
    return coupling_p.q, coupling_p.scale, None


def gibbs_sweeps_sparse_int8_reference(
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
    """The plain PyTorch version of the kernel, with its table: per sweep,
    per color-class span of ``class_spans(plan)``, fields = the int32 sum
    over the table's slots of A[k, c] · s[k] (read from the stored coupling
    at the table's offsets) + h / scale; then the sigmoid at β · scale, the
    draw and ΔE as ``gibbs_sweeps_kernel_reference`` computes them (per
    block of the span: uniforms drawn from ``generator`` block by block in
    plan order, ΔE summed block by block; × scale at the end).

    ``coupling_p``: a ``QuantCoupling`` or int8 ``BlockSparseCoupling``;
    ``uniforms``: at least ``n_sweeps`` rows of (chains, n_pad), read at
    [sweep, row, column].  Returns new f32 spins, or (spins, delta_e)."""
    chains, n_pad = spins_p.shape
    if n_pad != plan.n_pad:
        raise ValueError(f"spins have {n_pad} columns, the plan {plan.n_pad}")
    mat, scale, chunk = _stored(coupling_p, plan)
    dev = spins_p.device
    nbr, off, _spans = _device_table(plan, chunk, dev)
    nbr = nbr.long()
    vals = torch.where(off >= 0, mat.reshape(-1)[off.clamp(min=0).long()].to(torch.int32), 0)
    hq = hp / scale
    beta_col = torch.as_tensor(beta, dtype=torch.float32, device=dev) * scale
    beta_col = beta_col.reshape(-1, 1) if beta_col.ndim else beta_col
    s = spins_p.to(torch.float32).clone()
    s_int = s.to(torch.int32)
    de = torch.zeros(chains, dtype=torch.float32, device=dev)
    gdev = generator.device if generator is not None else dev
    for sweep in range(n_sweeps):
        for c0, c1, b0, b1 in class_spans(plan):
            acc = torch.zeros((chains, c1 - c0), dtype=torch.int32, device=dev)
            for d in range(nbr.shape[0]):
                acc += s_int[:, nbr[d, c0:c1]] * vals[d, c0:c1]
            fields = acc.to(torch.float32) + hq[c0:c1]
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
            s_int[:, c0:c1] = new.to(torch.int32)
    return (s, de * scale) if track_delta_e else s


def gibbs_sweeps_sparse_int8(
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
    """``n_sweeps`` colored block-Gibbs sweeps with an int8 coupling (a
    ``QuantCoupling``, or int8 ``BlockSparseCoupling`` panels) through the
    sparse gather kernel.

    ``hp`` (n_pad,) and ``spins_p`` (chains, n_pad) f32, ``beta`` scalar
    or (chains,); optional fed ``uniforms`` (>= n_sweeps, chains, n_pad)
    f32, else the kernel draws from K1's Philox stream keyed by a seed
    drawn from ``generator``.  Returns new f32 spins, or (spins, delta_e)
    with ``track_delta_e`` (rescaled to the coupling's units).  A CPU
    ``spins_p`` runs the plain version; a CUDA one launches the kernel, and
    anything it does not take raises.  ``count`` = (counter, mode name):
    the launch adds one there.  ``_shape`` overrides ``launch_shape``
    (chains per block, threads) for measuring the kernel."""
    if spins_p.device.type == "cpu":
        return gibbs_sweeps_sparse_int8_reference(
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
    _check("spins_p", spins_p, (n_chains, n_pad), dev)
    _check("coupling", mat, tuple(mat.shape), dev, torch.int8)
    _check("hp", hp, (n_pad,), dev)
    g, threads = _shape or launch_shape(
        plan, n_chains, torch.cuda.get_device_properties(dev).multi_processor_count)
    if (g not in _CHAINS or not _fits(g, n_pad) or n_pad >= _MAX_N_PAD
            or threads % 32 or threads % g or not 32 <= threads <= 1024):
        raise ValueError(f"{g} chains of n_pad={n_pad} a block at {threads} threads do not "
                         f"fit the int8 sweep kernel")
    nbr, off, spans = _device_table(plan, chunk, dev)
    beta_t = torch.as_tensor(beta, dtype=torch.float32, device=dev)
    if beta_t.ndim == 0:
        beta_t = beta_t.expand(n_chains)
    hq = hp / scale  # quantized units, computed on the device (no host sync)
    beta_t = (beta_t * scale).contiguous()
    _check("beta", beta_t, (n_chains,), dev)
    if uniforms is not None:
        if uniforms.shape[0] < n_sweeps:
            raise ValueError(f"uniforms need {n_sweeps} sweeps, got {uniforms.shape[0]}")
        _check("uniforms", uniforms, (uniforms.shape[0], n_chains, n_pad), dev)
        seed = None
    else:
        seed = draw_seed(generator, dev)
    out = torch.empty_like(spins_p)
    entry = torch.empty(nbr.shape, dtype=torch.int32, device=dev)
    delta_e = torch.empty(n_chains, dtype=torch.float32, device=dev) if track_delta_e else None
    lib = load_library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.gibbs_sparse_int8(
            mat.data_ptr(), nbr.data_ptr(), off.data_ptr(), entry.data_ptr(), nbr.shape[0],
            spins_p.data_ptr(), out.data_ptr(), hq.data_ptr(), beta_t.data_ptr(),
            uniforms.data_ptr() if uniforms is not None else None,
            seed.data_ptr() if seed is not None else None,
            delta_e.data_ptr() if delta_e is not None else None,
            spans.data_ptr(), spans.shape[0], n_chains, n_pad, int(n_sweeps), g, threads, stream,
        )
    if err != 0:
        msg = lib.gibbs_sparse_int8_error_string(err).decode()
        raise RuntimeError(f"gibbs_sparse_int8 launch failed: {msg} ({err})")
    if count is not None:
        count[0][count[1]] += 1
    return (out, delta_e * scale) if track_delta_e else out
