"""K4's owned-window update on the CPU: ``span_update_window_reference``
(the plain version of the window kernel) against the composition it
replaces and against the JAX body's window write and ΔE partial, and the
graph-sharded sweep's calls of the window entry.

The composition is the sweep's earlier epilogue: the span's fields
(``partial`` all-reduced, int8 totals scaled out, plus ``h``; ``h`` alone
where no shard couples into the span), ``span_update_reference`` on the
whole span, the owned columns sliced out, ``fields · (new − old)`` summed
into ΔE and the new spins written into the window in the carry's dtype.
Both run the same PyTorch ops on the CPU, so spins and ΔE are held
bit for bit.  The JAX side is the body of
``image_generation_tpu/ops/gibbs_graph_sharded.py`` ``_sweep_body`` (the
fields, ``_xla_update`` fed the same uniforms, the margin-buffer write and
the masked ΔE sum), on values of a 1/256 grid: spins bit for bit, ΔE
within 1e-6 relative (the JAX body sums a masked window, the port the
owned columns).  Sweeps are bit-identical to the JAX sweep fed its own
threefry stream, as in tests/test_torch_graph_sharded.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops import gibbs_graph_sharded as jgs
from image_generation_tpu.ops.gibbs_graph_sharded_pallas import xla_stream_uniforms
from image_generation_tpu.ops.quant import quantize_coupling as jquantize
from image_generation_tpu.parallel.mesh import create_mesh as jcreate_mesh
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import gibbs_graph_sharded as tgs
from image_generation_tpu_torch.ops.gibbs_graph_sharded_cuda import (
    SpanWindowUpdate,
    philox_span_uniforms,
    span_update,
    span_update_reference,
    span_update_window,
    span_update_window_reference,
)
from test_torch_graph_sharded import _form, medium, run_ranks  # noqa: F401
from test_torch_training import _t


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread for this module, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROWS, N_PAD = 12, 160
SPAN = (40, 100)  # a class span of 60 columns
WINDOWS = {  # (lo, cols) of the rank's window
    "inside": (56, 24),  # [56, 80) inside the span
    "left": (16, 40),  # [16, 56) straddles its left edge
    "right": (80, 40),  # [80, 120) straddles its right edge
    "covering": (0, 160),  # [0, 160) covers it
}
CARRIES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
SEED = 0x5EED1234ABCD


def _case(carry: str, partial_kind: str, per_chain: bool, seed: int):
    """Inputs on a 1/256 grid: h (n_pad,), the span's partial (f32 for
    f32 / bf16 carries, int32 totals and a scale for int8, or None), β,
    the sweep's (rows, n_pad) uniforms, old ±1 spins of the whole row."""
    rng = np.random.default_rng(seed)
    width = SPAN[1] - SPAN[0]
    h = np.round(rng.uniform(-0.4, 0.4, N_PAD) * 256) / 256
    scale = None
    if partial_kind == "none":
        partial = None
    elif carry == "int8":
        partial = rng.integers(-600, 601, (ROWS, width)).astype(np.int32)
        scale = np.float32(3 / 256)
    else:
        partial = (np.round(rng.uniform(-2.5, 2.5, (ROWS, width)) * 256) / 256).astype(np.float32)
    beta = (rng.uniform(0.3, 2.0, ROWS).astype(np.float32) if per_chain else np.float32(0.8))
    u = rng.random((ROWS, N_PAD), dtype=np.float32)
    old = rng.choice([-1.0, 1.0], (ROWS, N_PAD)).astype(np.float32)
    return h.astype(np.float32), partial, scale, beta, u, old


def _composition(partial, h, beta, spins, lo, start, stop, scale, u, seed, row0, sweep, de):
    """The sweep's epilogue as it stood before the window kernel."""
    rows = spins.shape[0]
    if partial is None:
        fields = h[start:stop].expand(rows, stop - start).contiguous()
    else:
        fields = (partial.to(torch.float32) * scale if scale is not None else partial) + \
            h[start:stop]
    new = span_update_reference(fields, beta, uniforms=None if u is None else u[:, start:stop],
                                seed=seed, row0=row0, col0=start, sweep=sweep)
    a, b = max(start, lo), min(stop, lo + spins.shape[1])
    mine = new[:, a - start: b - start]
    old = spins[:, a - lo: b - lo].to(torch.float32)
    de = de + (fields[:, a - start: b - start] * (mine - old)).sum(-1)
    spins[:, a - lo: b - lo] = mine.to(spins.dtype)
    return spins, de


def _jax_window(partial, h, beta, s, lo, start, stop, scale, u, carry):
    """The JAX body's fields, update and window write with its ΔE partial
    (``_sweep_body``, image_generation_tpu/ops/gibbs_graph_sharded.py)."""
    c_loc, l_loc = s.shape
    width = stop - start
    hp = jnp.asarray(h)
    if partial is None:
        fields = jnp.broadcast_to(jax.lax.slice_in_dim(hp, start, stop), (c_loc, width))
    else:
        fields = jnp.asarray(partial)
        if scale is not None:
            fields = fields.astype(jnp.float32) * jnp.float32(scale)
        fields = fields + jax.lax.slice_in_dim(hp, start, stop)
    beta = jnp.asarray(beta)
    beta_col = beta if beta.ndim == 0 else beta[:, None]
    s = jnp.asarray(s).astype(carry)
    new = jgs._xla_update(None, fields, beta_col, jnp.arange(c_loc),
                          jnp.asarray(u[:, start:stop])).astype(s.dtype)
    g_cols = lo + jnp.arange(l_loc)
    in_block = (g_cols >= start) & (g_cols < stop)
    rel = start - lo
    off = (jnp.int32(0), jnp.clip(rel + width, 0, l_loc + width))
    buf = jax.lax.dynamic_update_slice(jnp.zeros((c_loc, l_loc + 2 * width), s.dtype), new, off)
    cand = jax.lax.slice(buf, (0, width), (c_loc, width + l_loc))
    buf_f = jax.lax.dynamic_update_slice(jnp.zeros((c_loc, l_loc + 2 * width), jnp.float32),
                                         fields, off)
    f_win = jax.lax.slice(buf_f, (0, width), (c_loc, width + l_loc))
    de = jnp.sum(jnp.where(in_block[None, :], f_win * (cand - s).astype(jnp.float32), 0.0),
                 axis=-1)
    return np.asarray(jnp.where(in_block[None, :], cand, s).astype(jnp.float32)), np.asarray(de)


# ---------------------------------------------------------------------------
# the plain version of the window kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("carry", sorted(CARRIES))
def test_window_reference_is_the_composition_and_the_jax_write(carry, window):
    """For each carry and window, with and without a partial, scalar and
    per-chain β, fed and Philox uniforms: the window entry (its CPU
    branch), ``SpanWindowUpdate`` and ``span_update_window_reference``
    equal the composition bit for bit, spins and ΔE, and the JAX body's
    window write (Philox fed to it through ``philox_span_uniforms``)."""
    lo, cols = WINDOWS[window]
    start, stop = SPAN
    dtype = CARRIES[carry]
    row0, sweep = 5, 2
    checked = 0
    for partial_kind in ("products", "none"):
        for per_chain in (False, True):
            for draw in ("fed", "philox"):
                h, partial, scale, beta, u, old = _case(carry, partial_kind, per_chain,
                                                        7 + checked)
                if draw == "philox":
                    u = np.zeros_like(u)
                    u[:, start:stop] = philox_span_uniforms(SEED, sweep, row0, ROWS, start,
                                                            stop - start)
                    fed, seed = None, torch.tensor([SEED])
                else:
                    fed, seed = _t(u), None
                s0 = _t(old[:, lo:lo + cols]).to(dtype)
                tp = None if partial is None else torch.from_numpy(partial)
                ts = None if scale is None else torch.tensor(scale)
                want, want_de = _composition(tp, _t(h), _t(beta), s0.clone(), lo, start, stop,
                                             ts, fed, seed, row0, sweep, torch.zeros(ROWS))
                outs = []
                for entry in ("reference", "entry", "prepared"):
                    s, de = s0.clone(), torch.zeros(ROWS)
                    kw = dict(scale=ts, uniforms=fed, seed=seed, row0=row0)
                    if entry == "reference":
                        span_update_window_reference(tp, _t(h), _t(beta), s, lo, start, stop,
                                                     sweep=sweep, delta_e=de, **kw)
                    elif entry == "entry":
                        assert span_update_window(tp, _t(h), _t(beta), s, lo, start, stop,
                                                  sweep=sweep, delta_e=de, **kw) is s
                    else:
                        SpanWindowUpdate(s, lo, _t(beta), h=_t(h), delta_e=de, **kw)(
                            tp, start, stop, sweep)
                    assert s.dtype == dtype
                    assert torch.equal(s, want) and torch.equal(de, want_de), (entry, draw)
                    outs.append(s)
                j_s, j_de = _jax_window(partial, h, beta, old[:, lo:lo + cols], lo, start,
                                        stop, scale, u, jnp.dtype(str(dtype).split(".")[1]))
                np.testing.assert_array_equal(outs[0].to(torch.float32).numpy(), j_s)
                np.testing.assert_allclose(want_de.numpy(), j_de, rtol=1e-6, atol=1e-6)
                checked += 1
    assert checked == 8


@pytest.mark.parametrize("carry", sorted(CARRIES))
def test_disjoint_window_takes_no_call(carry):
    """A window that owns no column of the span: the entry refuses it
    (the sweep makes no call there) and the JAX body's write leaves the
    window and ΔE as they were."""
    h, partial, scale, beta, u, old = _case(carry, "products", False, 3)
    start, stop = SPAN
    s = _t(old[:, 100:140]).to(CARRIES[carry])
    kw = dict(scale=None if scale is None else torch.tensor(scale), uniforms=_t(u))
    for lo in (100, 0):  # right after the span; a window ending where it starts
        with pytest.raises(ValueError, match="no column"):
            span_update_window_reference(torch.from_numpy(partial), _t(h), float(beta), s, lo,
                                         start, stop, **kw)
    with pytest.raises(ValueError, match="no column"):
        SpanWindowUpdate(s, 100, float(beta), h=_t(h), **kw)(torch.from_numpy(partial), start,
                                                             stop, 0)
    assert torch.equal(s, _t(old[:, 100:140]).to(CARRIES[carry]))
    j_s, j_de = _jax_window(partial, h, beta, old[:, 100:140], 100, start, stop, scale, u,
                            jnp.dtype(str(CARRIES[carry]).split(".")[1]))
    np.testing.assert_array_equal(j_s, old[:, 100:140])
    assert not j_de.any()


def _fma_splitting_case(rows: int = 4096):
    """int32 totals, a scale and an h whose single-rounding fma(q, scale,
    h) differs from round(round(q · scale) + h) for many totals."""
    q = np.random.default_rng(0).integers(-5000, 5001, rows).astype(np.int32)
    scale, h = np.float32(0.0123456789), np.float32(0.3456789)
    two = (q.astype(np.float32) * scale) + h  # numpy rounds each f32 op
    fused = (q.astype(np.float64) * np.float64(scale) + np.float64(h)).astype(np.float32)
    return q, scale, h, two, fused


def test_int8_fields_round_twice_as_jax():
    """The int8 scale-out and the add of h round twice, as the JAX body's
    ``fields.astype(f32) * q_scale + hp``: on totals where one fused
    multiply-add would differ, the plain version's fields (read back from
    ΔE on a one-column window: 2·f where the new spin is +1 and the old
    −1) equal JAX's bit for bit, not the fused values."""
    q, scale, h, two, fused = _fma_splitting_case()
    assert (two != fused).mean() > 0.05  # the data separates the two roundings
    rows = q.size
    hp = torch.tensor([0.0, 0.0, 0.0, float(h)])
    s = torch.full((rows, 1), -1, dtype=torch.int8)
    de = torch.zeros(rows)
    span_update_window_reference(torch.from_numpy(q.reshape(rows, 1)), hp, 1e-3, s, 3, 3, 4,
                                 scale=torch.tensor(scale), uniforms=torch.zeros((rows, 4)),
                                 delta_e=de)
    assert bool((s == 1).all())
    fields = de.numpy() / 2
    jax_fields = np.asarray(jnp.asarray(q).astype(jnp.float32) * jnp.float32(scale)
                            + jnp.float32(h))
    np.testing.assert_array_equal(jax_fields, two)
    np.testing.assert_array_equal(fields, two)
    assert (fields != fused).any()


# ---------------------------------------------------------------------------
# the sweep's calls of the window entry
# ---------------------------------------------------------------------------

def _count_calls(monkeypatch):
    """Record (window lo, start, stop, sweep) of every call of the window
    entry, then run it."""
    calls, call = [], SpanWindowUpdate.__call__

    def counted(self, partial, start, stop, sweep):
        calls.append((self.lo, start, stop, sweep))
        return call(self, partial, start, stop, sweep)

    monkeypatch.setattr(SpanWindowUpdate, "__call__", counted)
    return calls


def _owned_calls(plan, axis, n_sweeps):
    want = []
    for g in range(axis):
        lo, hi = g * plan.n_pad // axis, (g + 1) * plan.n_pad // axis
        want += [(lo, start, stop, sw) for sw in range(n_sweeps)
                 for start, stop, _b0, _b1 in tgibbs.class_spans(plan)
                 if max(start, lo) < min(stop, hi)]
    return sorted(want)


@pytest.mark.parametrize("axis", [2, 4, 8])
@pytest.mark.parametrize("form", ["dense", "int8", "packed"])
def test_sweep_calls_the_window_once_per_owned_span(medium, monkeypatch, form, axis):  # noqa: F811
    """In kernel mode every rank calls the window entry exactly once for
    each (sweep, span) it owns columns of and never otherwise, and the
    sweep equals the plain update (``use_kernel=False``) bit for bit, ΔE
    included, on the same fed uniforms."""
    _jg, _jplan, tplan, hp, a, _h, _j = medium
    n_chains, n_sweeps = 8, 2
    rng = np.random.default_rng(axis)
    s0 = rng.choice([-1.0, 1.0], (n_chains, tplan.n_pad)).astype(np.float32)
    u = _t(rng.random((n_sweeps, n_chains, tplan.n_pad), dtype=np.float32))
    beta = _t(rng.uniform(0.5, 1.5, n_chains).astype(np.float32))

    def run(use_kernel):
        def rank(mesh):
            lo, hi = mesh.window(tplan.n_pad)
            return tgs.gibbs_sweeps_graph_sharded(
                _t(hp), _form(a, form, tplan, mesh), tplan, _t(s0[:, lo:hi]), n_sweeps, mesh,
                beta, uniforms=u, track_delta_e=True, use_kernel=use_kernel)

        outs = run_ranks(axis, rank)
        return torch.cat([o[0] for o in outs], 1), outs[0][1]

    plain = run(False)
    calls = _count_calls(monkeypatch)
    assert not calls
    kernel = run(True)
    assert sorted(calls) == _owned_calls(tplan, axis, n_sweeps)
    assert torch.equal(kernel[0], plain[0]) and torch.equal(kernel[1], plain[1])


@pytest.fixture(scope="module")
def straddling(medium):  # noqa: F811
    """The medium graph padded to 8 (n_pad 64, class spans [0, 24), [24,
    48), [48, 56), [56, 64)): windows of 2, 4 or 8 ranks straddle span
    edges or lie inside a span."""
    jg, _jplan, _tplan, _hp, _a, h, j = medium
    jplan = jgibbs.build_plan(jg, pad_to=8)
    tplan = tgibbs.build_plan(tgrbm.GRBMGraph(n=jg.n, edge_i=jg.edge_i, edge_j=jg.edge_j),
                              pad_to=8)
    assert tplan.n_pad == jplan.n_pad == 64
    assert [sp[:2] for sp in tgibbs.class_spans(tplan)] == [(0, 24), (24, 48), (48, 56), (56, 64)]
    hp, a = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(j))
    return jplan, tplan, np.asarray(hp), np.asarray(a)


@pytest.mark.parametrize("axis", [2, 4, 8])
@pytest.mark.parametrize("form", ["dense", "int8"])
def test_sweep_with_straddling_windows_matches_jax(straddling, monkeypatch, form, axis):
    """Windows that straddle span edges or lie inside a span: the port's
    sweep in kernel mode, fed the JAX body's threefry stream, is
    bit-identical to ``gibbs_sweeps_graph_sharded`` on a (1, P) mesh with
    per-chain β, ΔE within 1e-6 relative; one call per owned (sweep,
    span)."""
    jplan, tplan, hp, a = straddling
    n_chains, n_sweeps = 16, 3
    key = jax.random.PRNGKey(axis)
    s0 = np.asarray(jgibbs.random_spins(jax.random.PRNGKey(11), jplan, n_chains))
    beta = np.random.default_rng(axis).uniform(0.4, 1.8, n_chains).astype(np.float32)
    jmesh = jcreate_mesh(axis, shape=(1, axis))
    coupling = jquantize(jnp.asarray(a)) if form == "int8" else jnp.asarray(a)
    ref, de_ref = jax.jit(lambda c, s: jgs.gibbs_sweeps_graph_sharded(
        key, jnp.asarray(hp), c, jplan, s, n_sweeps, jmesh, beta=jnp.asarray(beta),
        track_delta_e=True))(coupling, jnp.asarray(s0))
    u = _t(xla_stream_uniforms(key, jplan, n_chains, n_sweeps))
    calls = _count_calls(monkeypatch)

    def rank(mesh):
        lo, hi = mesh.window(tplan.n_pad)
        return tgs.gibbs_sweeps_graph_sharded(
            _t(hp), _form(a, form, tplan, mesh), tplan, _t(s0[:, lo:hi]), n_sweeps, mesh,
            _t(beta), uniforms=u, track_delta_e=True)

    outs = run_ranks(axis, rank)
    np.testing.assert_array_equal(torch.cat([o[0] for o in outs], 1).numpy(), np.asarray(ref))
    for _s, de in outs:
        np.testing.assert_allclose(de.numpy(), np.asarray(de_ref), rtol=1e-6, atol=1e-6)
    assert sorted(calls) == _owned_calls(tplan, axis, n_sweeps)


def test_whole_span_entry_is_the_window_case():
    """``span_update`` keeps its signature: on the CPU it is
    ``span_update_reference``, and it equals the window entry with the
    span as the window and a fresh f32 buffer (no h, the fields as the
    partial)."""
    rng = np.random.default_rng(5)
    fields = _t(rng.uniform(-3, 3, (9, 30)).astype(np.float32))
    u = _t(rng.random((9, 30), dtype=np.float32))
    beta = _t(rng.uniform(0.2, 2.0, 9).astype(np.float32))
    seed = torch.tensor([77])
    for kw in (dict(uniforms=u), dict(seed=seed, row0=4, col0=200, sweep=1)):
        span_update.launches.clear()
        out = span_update(fields, beta, **kw)
        assert not span_update.launches  # the CPU branch counts nothing
        col0 = kw.get("col0", 0)
        win = torch.zeros((9, 30))
        SpanWindowUpdate(win, col0, beta, uniforms=kw.get("uniforms"), seed=kw.get("seed"),
                         u_col0=col0, row0=kw.get("row0", 0))(fields, col0, col0 + 30,
                                                              kw.get("sweep", 0))
        assert torch.equal(out, span_update_reference(fields, beta, **kw))
        assert torch.equal(win, out)


def test_window_entry_refuses_what_it_does_not_take():
    """Exactly one of uniforms and seed, a β of the window's rows, a
    (rows,) ΔE, uniforms of the window's rows, a sweep inside the fed
    ones; a device with no kernel."""
    s = torch.ones((4, 8))
    u = torch.rand((2, 4, 16))
    bad = (dict(), dict(uniforms=u, seed=torch.tensor([1])), dict(uniforms=u, beta=torch.ones(3)),
           dict(uniforms=u, delta_e=torch.zeros(5)), dict(uniforms=torch.rand((3, 16))))
    for kw in bad:
        beta = kw.pop("beta", 1.0)
        with pytest.raises(ValueError):
            SpanWindowUpdate(s, 0, beta, h=torch.zeros(16), **kw)
    with pytest.raises(ValueError, match="fed sweeps"):
        SpanWindowUpdate(s, 0, 1.0, h=torch.zeros(16), uniforms=u)(None, 0, 8, 2)
    with pytest.raises(ValueError, match="no span-update kernel"):
        SpanWindowUpdate(s.to("meta"), 0, 1.0, h=torch.zeros(16, device="meta"),
                         uniforms=u.to("meta"))
