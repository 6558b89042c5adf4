"""Port parity: int8 quantization, block-sparse packing and the plain
versions of the streaming sweep kernels K2 and K3, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs ``gibbs_sweeps_pallas_hbm`` in interpret mode with fed
uniforms, as its own tests do.  The port runs ``gibbs_sweeps_hbm_cuda`` on
CPU tensors, which is the kernels' plain version: in every value type the
gather kernel's, ``gibbs_sparse.gibbs_sweeps_sparse_reference``.

Tolerances.  Quantization and packing are bit-identical.  Sweeps: at
least 98 % of the chains bit-identical (the chain rule: the two sum the
fields in another order and compute the sigmoid with other code, so a
draw within an ulp of its probability can flip and its chain diverges);
on identical chains ΔE within 1e-3·(1 + |E|) at |J| ≤ 1 (f32 sums of
~400 in another order), the ΔE rule.  With integer-valued couplings every
sum is exact, so spins are bit-identical and ΔE exact.  Energies within
1e-5·(1 + |E|).
"""

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from image_generation_tpu.models import grbm as jgrbm
from image_generation_tpu.ops import block_sparse as jbs
from image_generation_tpu.ops import gibbs as jgibbs
from image_generation_tpu.ops import quant as jquant
from image_generation_tpu.ops.gibbs_pallas_hbm import gibbs_sweeps_pallas_hbm
from image_generation_tpu_torch.models import grbm as tgrbm
from image_generation_tpu_torch.ops import block_sparse as tbs
from image_generation_tpu_torch.ops import gibbs as tgibbs
from image_generation_tpu_torch.ops import quant as tquant
from image_generation_tpu_torch.ops.gibbs_sparse import gibbs_sweeps_sparse_reference
from image_generation_tpu_torch.ops.gibbs_hbm_cuda import (
    gibbs_sweeps_hbm_cuda,
    gibbs_sweeps_hbm_reference,
    round_sweeps,
)

CHAIN_RULE = 0.98
CHAINS = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _edges384():
    """251 spins in three colors (n_pad 384): a ring, local chords between
    its even and odd spins, and one spin joined to two neighbours."""
    rng = np.random.default_rng(0)
    pairs = {tuple(sorted((i, (i + 1) % 250))) for i in range(250)}
    ev, od = np.arange(0, 250, 2), np.arange(1, 250, 2)
    for _ in range(500):
        a, b = int(rng.choice(ev)), int(rng.choice(od))
        if abs(a - b) < 40:
            pairs.add((min(a, b), max(a, b)))
    pairs |= {(0, 250), (1, 250)}
    return 251, np.array(sorted(pairs))


def _both(n, edges, **plan_kw):
    jg = jgrbm.GRBMGraph(n=n, edge_i=edges[:, 0], edge_j=edges[:, 1])
    tg = tgrbm.GRBMGraph(n=n, edge_i=edges[:, 0], edge_j=edges[:, 1])
    return jg, jgibbs.build_plan(jg, **plan_kw), tgibbs.build_plan(tg, **plan_kw)


@pytest.fixture(scope="module")
def g384():
    """(JAX plan, port plan, {model: (hp, A) numpy}) on the 384-wide plan:
    a |J| ≤ 1 model and an integer-valued one (h integers, J = ±1)."""
    n, edges = _edges384()
    jg, jplan, tplan = _both(n, edges)
    assert jplan.n_pad == tplan.n_pad == 384 and len(jplan.blocks) == 3
    rng = np.random.default_rng(1)
    raw = {
        "strong": (rng.uniform(-0.5, 0.5, n), rng.uniform(-1.0, 1.0, len(edges))),
        "integer": (np.round(rng.normal(size=n)), rng.choice([-1.0, 1.0], len(edges))),
    }
    models = {}
    for name, (h, j) in raw.items():
        hp, a = jgibbs.permuted_model(jplan, jnp.asarray(h, jnp.float32),
                                      jnp.asarray(j, jnp.float32))
        models[name] = (np.asarray(hp), np.asarray(a))
    return jplan, tplan, models


@pytest.fixture(scope="module")
def medium():
    """The JAX tests' ``medium`` fixture: a 60-spin 6-regular graph on a
    plan padded to 8 (chunks of 24 clamp)."""
    G = nx.random_regular_graph(6, 60, seed=3)
    G = nx.relabel_nodes(G, {v: i for i, v in enumerate(sorted(G.nodes()))})
    edges = np.array(sorted(G.edges()))
    _, jplan, tplan = _both(60, edges, pad_to=8)
    rng = np.random.RandomState(0)
    h = rng.randn(60).astype(np.float32)
    q = rng.randn(len(edges)).astype(np.float32)
    hp, a = jgibbs.permuted_model(jplan, jnp.asarray(h), jnp.asarray(q))
    return jplan, tplan, np.asarray(a)


def _forms(a):
    """(JAX coupling, port coupling) of one dense numpy matrix per form."""
    return {
        "f32": (jnp.asarray(a), _t(a)),
        "bf16": (jnp.asarray(a).astype(jnp.bfloat16), _t(a).to(torch.bfloat16)),
        "int8": (jquant.quantize_coupling(jnp.asarray(a)), tquant.quantize_coupling(_t(a))),
    }


def _same(jax_arr, port_t):
    np.testing.assert_array_equal(np.asarray(jnp.asarray(jax_arr).astype(jnp.float32)),
                                  port_t.to(torch.float32).numpy())
    assert str(jnp.asarray(jax_arr).dtype) == str(port_t.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# quantization and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["strong", "checkpoint_scale", "ties", "zero"])
def test_quantize_matches_jax(kind):
    """Bit-identical q and scale, including exact .5 ties (half to even)
    and the zero matrix (scale 1)."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-1.0, 1.0, (64, 64)).astype(np.float32)
    if kind == "checkpoint_scale":
        a *= 0.05
    elif kind == "ties":  # max 127 → scale 1: every k + 0.5 is a tie
        a = np.round(rng.uniform(-120, 120, (64, 64))).astype(np.float32) + 0.5
        a[0, 0] = 127.0
    elif kind == "zero":
        a = np.zeros((64, 64), np.float32)
    a = a + a.T
    jq, tq = jquant.quantize_coupling(jnp.asarray(a)), tquant.quantize_coupling(_t(a))
    _same(jq.q, tq.q)
    assert float(jq.scale) == float(tq.scale) and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jquant.dequantize_coupling(jq)),
                                  tquant.dequantize_coupling(tq).numpy())


@pytest.mark.parametrize("chunk", [128, 256])  # 256 ∤ 384: the final chunk clamps
@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_pack_matches_jax(g384, chunk, form):
    jplan, tplan, models = g384
    jc, tc = _forms(models["strong"][1])[form]
    jp, tp = jbs.pack_coupling(jplan, jc, chunk), tbs.pack_coupling(tplan, tc, chunk)
    assert tbs.chunk_starts(384, chunk) == jbs.chunk_starts(384, chunk)
    assert tbs.panel_offsets(tplan, chunk) == jbs.panel_offsets(jplan, chunk)
    _same(jp.panels, tp.panels)
    assert tp.quantized == jp.quantized == (form == "int8") and tp.chunk == chunk
    if tp.quantized:
        assert float(tp.scale) == float(jp.scale)


@pytest.mark.parametrize("chunk", [8, 24])  # 24 ∤ n_pad: the final chunk clamps
def test_pack_matches_jax_medium(medium, chunk):
    jplan, tplan, a = medium
    for jc, tc in _forms(a).values():
        _same(jbs.pack_coupling(jplan, jc, chunk).panels,
              tbs.pack_coupling(tplan, tc, chunk).panels)


# ---------------------------------------------------------------------------
# energies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("packed", [False, True])
def test_ising_energies_forms_match_jax(g384, form, packed):
    jplan, tplan, models = g384
    hp, a = models["strong"]
    jc, tc = _forms(a)[form]
    if packed:
        jc, tc = jbs.pack_coupling(jplan, jc, 128), tbs.pack_coupling(tplan, tc, 128)
    s = np.random.default_rng(4).choice([-1.0, 1.0], (3, 8, 384)).astype(np.float32)
    ref = np.asarray(jgibbs.ising_energies(jnp.asarray(hp), jc, jnp.asarray(s),
                                           jnp.bfloat16 if form == "bf16" else None))
    ours = tgibbs.ising_energies(_t(hp), tc, _t(s)).numpy()
    assert ours.shape == (3, 8)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * (1 + np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the plain K2 and K3 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def _inputs(seed, n_pad, sweeps=4):
    rng = np.random.default_rng(seed)
    s0 = rng.choice([-1.0, 1.0], (CHAINS, n_pad)).astype(np.float32)
    u = rng.random((sweeps, CHAINS, n_pad), dtype=np.float32)
    beta = rng.uniform(0.5, 2.0, CHAINS).astype(np.float32)
    return s0, u, beta


def _run_both(jplan, tplan, hp, jc, tc, n_sweeps, track, seed, block_dtype=jnp.float32,
              beta_one=False):
    s0, u, beta = _inputs(seed, jplan.n_pad, round_sweeps(n_sweeps))
    if beta_one:
        beta = np.ones(CHAINS, np.float32)
    out = gibbs_sweeps_pallas_hbm(
        jax.random.PRNGKey(0), jnp.asarray(hp), jc, jplan, jnp.asarray(s0), n_sweeps,
        jnp.asarray(beta), block_dtype=block_dtype, interpret=True, uniforms=jnp.asarray(u),
        track_delta_e=track)
    ours = gibbs_sweeps_hbm_cuda(_t(hp), tc, tplan, _t(s0), n_sweeps, _t(beta),
                                 uniforms=_t(u), track_delta_e=track)
    if track:
        return (np.asarray(out[0]), np.asarray(out[1])), (ours[0].numpy(), ours[1].numpy())
    return (np.asarray(out), None), (ours.numpy(), None)


def _check_sweeps(ref, ours, hp, a, exact):
    (rs, rde), (os_, ode) = ref, ours
    assert os_.shape == rs.shape and set(np.unique(os_)) <= {-1.0, 1.0}
    same = (os_ == rs).all(axis=1)
    if exact:
        assert same.all()
    assert same.mean() >= CHAIN_RULE
    if rde is not None:
        if exact:
            np.testing.assert_array_equal(ode, rde)
        e = np.abs(np.asarray(jgibbs.ising_energies(jnp.asarray(hp), jnp.asarray(a),
                                                    jnp.asarray(rs))))
        assert (np.abs(ode - rde)[same] <= 1e-3 * (1 + e[same])).all()


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("track,sweeps", [(False, 4), (True, 3)])
def test_plain_k2_matches_pallas(g384, form, track, sweeps):
    """Dense coupling (K2): f32, a bf16 block dtype, a QuantCoupling; with
    and without ΔE; 3 sweeps run as 4."""
    jplan, tplan, models = g384
    hp, a = models["strong"]
    jc, tc = _forms(a)[form]
    if form == "bf16":  # the JAX wrapper casts an f32 coupling to its block dtype
        jc = jnp.asarray(a)
    ref, ours = _run_both(jplan, tplan, hp, jc, tc, sweeps, track, seed=10 + sweeps,
                          block_dtype=jnp.bfloat16 if form == "bf16" else jnp.float32)
    _check_sweeps(ref, ours, hp, a, exact=False)


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_plain_k2_exact_on_integer_couplings(g384, form):
    """Integer h and J = ±1: every sum is exact in any order, so the port's
    plain versions (bf16 and int8: the gather's) equal the Pallas kernel
    bit for bit, spins and ΔE."""
    jplan, tplan, models = g384
    hp, a = models["integer"]
    jc, tc = _forms(a)[form]
    if form == "bf16":  # the JAX wrapper casts an f32 coupling to its block dtype
        jc = jnp.asarray(a)
    ref, ours = _run_both(jplan, tplan, hp, jc, tc, 3, True, seed=20, beta_one=True,
                          block_dtype=jnp.bfloat16 if form == "bf16" else jnp.float32)
    _check_sweeps(ref, ours, hp, a, exact=True)


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_plain_k3_matches_pallas(g384, form, chunk):
    """Packed panels (K3) in bf16 and int8, chunks 128 and 256 (clamped),
    with ΔE, 3 sweeps run as 4."""
    jplan, tplan, models = g384
    hp, a = models["strong"]
    jc, tc = _forms(a)[form]
    jp, tp = jbs.pack_coupling(jplan, jc, chunk), tbs.pack_coupling(tplan, tc, chunk)
    ref, ours = _run_both(jplan, tplan, hp, jp, tp, 3, True, seed=30 + chunk)
    _check_sweeps(ref, ours, hp, a, exact=False)


@pytest.mark.parametrize("chunk", [128, 256])
@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_plain_k3_equals_plain_k2_on_integer_couplings(g384, form, chunk):
    """On integer couplings every sum is exact, so the packed and the dense
    plain versions agree bit for bit, spins and ΔE; and both agree with
    the JAX packed kernel."""
    jplan, tplan, models = g384
    hp, a = models["integer"]
    jc, tc = _forms(a)[form]
    s0, u, _ = _inputs(40, 384)
    tp = tbs.pack_coupling(tplan, tc, chunk)
    k2 = gibbs_sweeps_hbm_reference(_t(hp), tc, tplan, _t(s0), 3, uniforms=_t(u),
                                    track_delta_e=True)
    k3 = gibbs_sweeps_hbm_reference(_t(hp), tp, tplan, _t(s0), 3, uniforms=_t(u),
                                    track_delta_e=True)
    assert torch.equal(k2[0], k3[0]) and torch.equal(k2[1], k3[1])
    ref, ours = _run_both(jplan, tplan, hp, jbs.pack_coupling(jplan, jc, chunk), tp, 3,
                          True, seed=40, beta_one=True)
    _check_sweeps(ref, ours, hp, a, exact=True)


def test_plain_k3_unoccupied_color_takes_fields_h():
    """A color block nothing couples into (isolated spins split off by
    ``max_class``) gets fields = h: the packed plain version still equals
    the dense one bit for bit."""
    n, edges = _edges384()
    n_iso = 64  # isolated spins, last in BFS order: class 0's last block
    tg = tgrbm.GRBMGraph(n=n + n_iso, edge_i=edges[:, 0], edge_j=edges[:, 1])
    plan = tgibbs.build_plan(tg, pad_to=64, max_class=64)
    rows = tbs.color_chunk_rows(plan, 64)
    assert () in rows  # an unoccupied color
    rng = np.random.default_rng(5)
    hp, a = tgibbs.permuted_model(plan, _t(np.round(rng.normal(size=tg.n)).astype(np.float32)),
                                  _t(rng.choice([-1.0, 1.0], len(edges)).astype(np.float32)))
    s0 = _t(rng.choice([-1.0, 1.0], (CHAINS, plan.n_pad)).astype(np.float32))
    u = _t(rng.random((2, CHAINS, plan.n_pad), dtype=np.float32))
    k2 = gibbs_sweeps_hbm_reference(hp, a, plan, s0, 2, uniforms=u, track_delta_e=True)
    k3 = gibbs_sweeps_hbm_reference(hp, tbs.pack_coupling(plan, a, 64), plan, s0, 2,
                                    uniforms=u, track_delta_e=True)
    assert torch.equal(k2[0], k3[0]) and torch.equal(k2[1], k3[1])


def test_plain_version_rounds_sweeps_and_counts_nothing(g384):
    """3 sweeps run as 4 (the gather's plain version at 4 sweeps with the
    same uniforms); the CPU path launches nothing; too few fed sweeps
    raise."""
    _, tplan, models = g384
    hp, a = (_t(x) for x in models["strong"])
    s0, u, _ = _inputs(50, 384)
    gibbs_sweeps_hbm_cuda.launches.clear()
    three = gibbs_sweeps_hbm_cuda(hp, a, tplan, _t(s0), 3, uniforms=_t(u))
    four = gibbs_sweeps_sparse_reference(hp, a, tplan, _t(s0), 4, uniforms=_t(u))
    assert torch.equal(three, four) and sum(gibbs_sweeps_hbm_cuda.launches.values()) == 0
    with pytest.raises(ValueError, match="uniforms"):
        gibbs_sweeps_hbm_cuda(hp, a, tplan, _t(s0), 3, uniforms=_t(u[:3]))
    assert [round_sweeps(n) for n in (1, 2, 3, 4, 5)] == [2, 2, 4, 4, 6]


def test_default_rows_fit_the_scaled_plan():
    """The chains per thread block of the streaming route at the scaled
    plan's shapes (n_pad 6,016, 128-wide blocks): every mode is the gather
    kernel's, whose launch shape gives G = 8 for the 2,048
    parallel-tempering chains, G = 1 for a 256-chain request and G = 4 for
    1,024 (tests/test_torch_sparse_int8.py holds it on the real plans)."""
    from image_generation_tpu_torch.ops.gibbs_sparse import launch_shape

    blocks = tuple((128 * i, 128 * i + 120, 128 * (i + 1)) for i in range(47))
    plan = tgibbs.GibbsPlan(n=5640, n_pad=6016, blocks=blocks, orig_to_perm=np.zeros(0),
                            perm_edge_i=np.zeros(0, np.int32),
                            perm_edge_j=np.zeros(0, np.int32),
                            valid_mask=np.zeros(6016, bool))
    assert launch_shape(plan, 2048)[0] == 8
    assert launch_shape(plan, 256)[0] == 1
    assert launch_shape(plan, 1024)[0] == 4
