"""The port's per-slot paged chunk attention (K3) and the model step that
runs it, against the JAX package on the CPU.

- K3's plain version (the wrapper on CPU tensors) against the Pallas
  kernel `paged_decode_attention_chunk_kernel` in interpret mode (as
  tests/test_paged_kv.py runs it) and against JAX's `decode_attention_chunk`
  on gathered pages: fp32 at atol/rtol 2e-5 (JAX's own bound between its
  two paths); dead queries and q_lens-0 slots exactly 0; an int8 pool at
  3e-5; a poisoned clamp-target page changes nothing.
- The kernel's own arithmetic, `paged_chunk_attention_tiled_reference`
  (flattened rows, 32-position tiles, online softmax in the log2 domain,
  bf16 P on the tensor-core path), against the Pallas kernel in
  interpret mode at n_q=12, n_kv=2 over windows ending at tile and page
  edges, at Q=13 and Q=1, fp32 (2e-5), int8 (3e-5) and bf16 inputs (each
  output row within 2^-7 of its largest value: P is rounded to bf16);
  dead queries, an all-dead slot and a poisoned clamp-target page as
  above.  bf16 q over an int8 pool (the replay's tensor-core walk: codes
  in the products, s_k on the scores, P' = bf16(P * s_v), l over the
  unscaled P) against the Pallas kernel and the plain version at 2^-7,
  and apart from the fp32 walk (it rounds P').
- K3's Q=1 entry point (`paged_decode_attention_kernel`, which runs K2)
  on the CPU against the Pallas `paged_decode_attention_kernel` in
  interpret mode: sentinel pages, a parked slot, a window past the
  table; fp32 at 2e-5, an int8 pool at 3e-4.
- `decode_step_spec_paged` with q_lens against JAX's on one set of
  tiny_config weights and one pool: live-query logits at atol 1e-5, the
  real pool pages equal, the positions of dead queries untouched."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.ops.attention import decode_attention_chunk as jax_chunk
from areal_tpu.ops.attention import paged_gather_layer as jax_gather
from areal_tpu.ops.pallas.paged_attention import paged_decode_attention_chunk_kernel as jax_kernel
from areal_tpu.ops.pallas.paged_attention import paged_decode_attention_kernel as jax_q1_kernel
from areal_tpu_torch.kernels import paged_chunk_attention as pca
from areal_tpu_torch.kernels import ragged_paged_attention as rpa
from areal_tpu_torch.models import transformer as ttfm
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.weights import params_from_numpy

torch.set_num_threads(2)

N_POOL, PS, MP, N_KV, D, REP, Q = 12, 8, 4, 2, 16, 3, 5


def _slots(rng):
    """4 slots of Q=5 queries: slot 0 all live (window 10..14, two
    pages), slot 1 ragged (2 live of 5, window 1..2), slot 2 parked
    (q_lens 0, sentinel table), slot 3 all four pages mapped with its
    window running past the table (which then bounds it).  Page N_POOL-1
    is never mapped: the clamp target of every sentinel entry."""
    k = rng.standard_normal((N_POOL, PS, N_KV, D)).astype(np.float32)
    v = rng.standard_normal((N_POOL, PS, N_KV, D)).astype(np.float32)
    pt = np.full((4, MP), N_POOL, np.int32)
    pt[0, :2] = (4, 9)
    pt[1, 0] = 2
    pt[3] = (0, 7, 3, 10)
    hi0 = np.array([10, 1, 0, 30], np.int32)
    ql = np.array([5, 2, 0, 4], np.int32)
    q = rng.standard_normal((4, Q, N_KV * REP, D)).astype(np.float32)
    return q, k, v, pt, hi0, ql


def _port(q, k, v, pt, hi0, ql, ks=None, vs=None):
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa: E731
    return pca.paged_decode_attention_chunk(
        t(q), t(k), t(v), t(pt), t(hi0), t(ql),
        None if ks is None else t(ks).to(torch.bfloat16),
        None if vs is None else t(vs).to(torch.bfloat16),
    ).numpy()


def _jax_gathered(q, k, v, pt, hi0, ql=None, ks=None, vs=None):
    pt = jnp.asarray(pt)
    kk, vv = jax_gather(jnp.asarray(k), pt), jax_gather(jnp.asarray(v), pt)
    sk = None if ks is None else jax_gather(jnp.asarray(ks, jnp.bfloat16), pt)
    sv = None if vs is None else jax_gather(jnp.asarray(vs, jnp.bfloat16), pt)
    return np.asarray(jax_chunk(
        jnp.asarray(q), kk, vv, jnp.zeros((q.shape[0],), jnp.int32),
        jnp.asarray(hi0), k_scale=sk, v_scale=sv,
        q_lens=None if ql is None else jnp.asarray(ql),
    ))


@pytest.fixture
def slots(rng):
    return _slots(rng)


def test_fp32_matches_jax_kernel_and_gathered_chunk(slots):
    q, k, v, pt, hi0, ql = slots
    out = _port(q, k, v, pt, hi0, ql)
    kern = jax_kernel(*(jnp.asarray(a) for a in (q, k, v, pt, hi0)), q_lens=jnp.asarray(ql))
    np.testing.assert_allclose(out, np.asarray(kern), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out, _jax_gathered(q, k, v, pt, hi0, ql), atol=2e-5, rtol=2e-5)


def test_without_q_lens_every_query_is_live(slots):
    """JAX's kernel without q_lens (every query live) against the port's
    with q_lens = Q on every row."""
    q, k, v, pt, hi0, _ = slots
    hi0 = np.array([10, 1, 4, 30], np.int32)
    out = _port(q, k, v, pt, hi0, np.full(4, Q, np.int32))
    np.testing.assert_allclose(
        out, np.asarray(jax_kernel(*(jnp.asarray(a) for a in (q, k, v, pt, hi0)))),
        atol=2e-5, rtol=2e-5,
    )
    assert (np.abs(out).max(axis=(2, 3)) > 0).all()


def test_dead_queries_and_parked_slots_exact_zero(slots):
    q, k, v, pt, hi0, ql = slots
    out = _port(q, k, v, pt, hi0, ql)
    assert float(np.abs(out[1, 2:]).max()) == 0.0
    assert float(np.abs(out[2]).max()) == 0.0
    assert float(np.abs(out[3, 4:]).max()) == 0.0
    live = np.abs(out).max(axis=(2, 3))
    assert (live[0] > 0).all() and (live[1, :2] > 0).all() and (live[3, :4] > 0).all()


def test_poisoned_clamp_target_changes_nothing(slots):
    """Twin of tests/test_paged_kv.py's sentinel test: page N_POOL-1,
    where sentinel entries clamp, is filled with 1e9; the output is
    bit-identical."""
    q, k, v, pt, hi0, ql = slots
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[N_POOL - 1] = 1e9
    v_bad[N_POOL - 1] = 1e9
    np.testing.assert_array_equal(
        _port(q, k, v, pt, hi0, ql), _port(q, k_bad, v_bad, pt, hi0, ql)
    )


def test_int8_pool_matches_jax(slots):
    q, _, _, pt, hi0, ql = slots
    r = np.random.default_rng(3)
    k8 = r.integers(-127, 128, (N_POOL, PS, N_KV, D)).astype(np.int8)
    v8 = r.integers(-127, 128, (N_POOL, PS, N_KV, D)).astype(np.int8)
    ks = (np.abs(r.standard_normal((N_POOL, PS, N_KV))) * 0.02 + 0.01).astype(np.float32)
    vs = (np.abs(r.standard_normal((N_POOL, PS, N_KV))) * 0.02 + 0.01).astype(np.float32)
    out = _port(q, k8, v8, pt, hi0, ql, ks, vs)
    kern = jax_kernel(
        *(jnp.asarray(a) for a in (q, k8, v8, pt, hi0)),
        jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16), q_lens=jnp.asarray(ql),
    )
    np.testing.assert_allclose(out, np.asarray(kern), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(
        out, _jax_gathered(q, k8, v8, pt, hi0, ql, ks, vs), atol=3e-5, rtol=3e-5
    )


def test_cpu_dispatch_never_launches(slots):
    before = pca.LAUNCHES
    _port(*slots)
    assert pca.LAUNCHES == before


def test_no_fallback_off_the_cpu(slots):
    """A tensor that is neither on the CPU nor on a CUDA card raises: the
    wrapper takes the plain version only for CPU tensors."""
    q, k, v, pt, hi0, ql = (torch.from_numpy(np.array(a)).to("meta") for a in slots)
    with pytest.raises(ValueError, match="device"):
        pca.paged_decode_attention_chunk(q, k, v, pt, hi0, ql)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_q1_entry_matches_jax_kernel(int8):
    """K3's Q=1 entry point on the CPU (K2's plain version, which it runs)
    against the JAX package's `paged_decode_attention_kernel` (the chunk
    kernel at Q=1) in interpret mode: slot 0 on two pages then
    sentinels, slot 1 parked (valid_to 0, a sentinel table), slot 2's
    window past its table (bounded by it), slot 3 one position; fp32 at
    2e-5, an int8 pool at 3e-4; the parked slot exactly 0 on both sides;
    no launch counted."""
    r = np.random.default_rng(7)
    pt = np.full((4, MP), N_POOL, np.int32)
    pt[0, :2] = (4, 9)
    pt[2] = (0, 7, 3, 10)
    pt[3, 0] = 2
    vt = np.array([13, 0, 40, 1], np.int32)
    q = r.standard_normal((4, 1, N_KV * REP, D)).astype(np.float32)
    ks = vs = tks = tvs = None
    if int8:
        k = r.integers(-127, 128, (N_POOL, PS, N_KV, D)).astype(np.int8)
        v = r.integers(-127, 128, (N_POOL, PS, N_KV, D)).astype(np.int8)
        ks, vs = (jnp.asarray(np.abs(r.standard_normal((N_POOL, PS, N_KV))) * 0.02 + 0.01,
                              jnp.bfloat16) for _ in range(2))
        tks, tvs = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                    for x in (ks, vs))
    else:
        k = r.standard_normal((N_POOL, PS, N_KV, D)).astype(np.float32)
        v = r.standard_normal((N_POOL, PS, N_KV, D)).astype(np.float32)
    want = np.asarray(jax_q1_kernel(*(jnp.asarray(a) for a in (q, k, v, pt, vt)), ks, vs))
    k2_before, k3_before = rpa.LAUNCHES, pca.LAUNCHES
    args = [torch.from_numpy(a) for a in (q, k, v, pt, vt)] + [tks, tvs]
    got = pca.paged_decode_attention_kernel(*args).numpy()
    tol = 3e-4 if int8 else 2e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    assert (got[1] == 0).all() and (want[1] == 0).all()
    assert (np.abs(got[[0, 2, 3]]).max(axis=(1, 2, 3)) > 0).all()
    np.testing.assert_array_equal(
        got[:, 0], rpa.ragged_paged_attention_reference(args[0][:, 0], *args[1:]).numpy()
    )
    assert (rpa.LAUNCHES, pca.LAUNCHES) == (k2_before, k3_before)


# --------------------------------------------------------------------------
# The kernel's tiled arithmetic
# --------------------------------------------------------------------------

E_NQ, E_NKV, E_D, E_PS, E_MP, E_POOL = 12, 2, 16, 16, 6, 24


def _edge_slots(rng, nq_tok, dtype):
    """Six slots at n_q=12, n_kv=2 (rep 6: 13 queries are 78 rows, which
    straddle queries and the kernel's 64-row blocks), page 16, against
    the kernel's 32-position tiles.  The last live query's window ends at
    32 (a tile and page edge), 48 (a page edge inside a tile), 64, past
    the table's 96 positions (which bound it), at 13 in a ragged slot (2
    of Q live) and nowhere in an all-dead slot (q_lens 0).  Page E_POOL-1
    is never mapped: the clamp target of every sentinel entry."""
    last = np.array([32, 48, 64, 102, 13, 42], np.int32)  # last live window
    ql = np.minimum(np.array([13, 13, 13, 13, 2, 0], np.int32), nq_tok)
    hi0 = (last - np.maximum(ql - 1, 0)).astype(np.int32)
    pages = [-(-min(int(x), E_PS * E_MP) // E_PS) for x in last[:5]] + [0]
    perm = rng.permutation(E_POOL - 1)
    pt = np.full((6, E_MP), E_POOL, np.int32)
    used = 0
    for s, n in enumerate(pages):
        pt[s, :n] = perm[used : used + n]
        used += n
    q = rng.standard_normal((6, nq_tok, E_NQ, E_D)).astype(np.float32)
    shape = (E_POOL, E_PS, E_NKV, E_D)
    if dtype == "bf16q_int8":  # bf16 q values, held as fp32 for the Pallas kernel
        q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
    if dtype in ("int8", "bf16q_int8"):
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (np.abs(rng.standard_normal(shape[:3])) * 0.02 + 0.01).astype(np.float32)
        vs = (np.abs(rng.standard_normal(shape[:3])) * 0.02 + 0.01).astype(np.float32)
        # the scales as bf16 holds them, so both packages read the same
        ks, vs = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (ks, vs))
        return q, k, v, pt, hi0, ql, ks, vs
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bf16":  # bf16 values, held as fp32 for the Pallas kernel
        q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (q, k, v))
    return q, k, v, pt, hi0, ql, None, None


def _tiled(q, k, v, pt, hi0, ql, ks, vs, dtype):
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    cast = bf if dtype == "bf16" else torch.from_numpy
    scale = (lambda x: None if x is None else bf(x))
    return pca.paged_chunk_attention_tiled_reference(
        bf(q) if dtype == "bf16q_int8" else cast(q), cast(k), cast(v),
        *(torch.from_numpy(a) for a in (pt, hi0, ql)), scale(ks), scale(vs),
    ).numpy()


def _row_err(got, want):
    """Largest per-row error relative to the row's largest |want| (rows
    under the output's RMS take the RMS), as chip_smoke.py measures."""
    err = np.abs(got - want).max(-1)
    mag = np.abs(want).max(-1)
    live = want[mag > 0]
    rms = float(np.sqrt(np.mean(live**2))) if live.size else 1.0
    return float((err / np.maximum(mag, rms)).max())


@pytest.mark.parametrize("nq_tok", [13, 1])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8", "bf16q_int8"])
def test_tiled_reference_matches_jax_kernel(rng, dtype, nq_tok):
    q, k, v, pt, hi0, ql, ks, vs = _edge_slots(rng, nq_tok, dtype)
    got = _tiled(q, k, v, pt, hi0, ql, ks, vs, dtype)
    jscale = (lambda x: None if x is None else jnp.asarray(x, jnp.bfloat16))
    want = np.asarray(jax_kernel(
        *(jnp.asarray(a) for a in (q, k, v, pt, hi0)), jscale(ks), jscale(vs),
        q_lens=jnp.asarray(ql),
    ))
    if dtype in ("bf16", "bf16q_int8"):
        # P (bf16 q over int8: P' = P * s_v) is rounded to bf16, the Pallas
        # kernel's stays fp32
        assert _row_err(got, want) <= 2**-7
    else:
        tol = 3e-5 if dtype == "int8" else 2e-5
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8", "bf16q_int8"])
def test_tiled_reference_zeros_and_poison(rng, dtype):
    """Dead queries and the all-dead slot are exactly 0; live rows are
    not; filling the clamp-target page with huge values changes
    nothing, bitwise."""
    q, k, v, pt, hi0, ql, ks, vs = _edge_slots(rng, 13, dtype)
    out = _tiled(q, k, v, pt, hi0, ql, ks, vs, dtype)
    live = np.arange(13)[None, :] < ql[:, None]
    assert float(np.abs(out[~live]).max()) == 0.0
    assert (np.abs(out[live]).max(-1) > 0).all()
    k_bad, v_bad = k.copy(), v.copy()
    k_bad[E_POOL - 1] = 127 if k.dtype == np.int8 else 1e9
    v_bad[E_POOL - 1] = 127 if k.dtype == np.int8 else 1e9
    np.testing.assert_array_equal(out, _tiled(q, k_bad, v_bad, pt, hi0, ql, ks, vs, dtype))


@pytest.mark.parametrize("nq_tok", [13, 1])
def test_tiled_reference_bf16q_int8_matches_plain(rng, nq_tok):
    """The model of bf16 q over an int8 pool (the replay's tensor-core
    walk) against the plain version on an fp32 copy of q, each output row
    within 2^-7 of its largest value (chip_smoke's bf16 row tolerance: P'
    is rounded to bf16); dead rows exactly 0 on both."""
    q, k, v, pt, hi0, ql, ks, vs = _edge_slots(rng, nq_tok, "bf16q_int8")
    got = _tiled(q, k, v, pt, hi0, ql, ks, vs, "bf16q_int8")
    want = _port(q, k, v, pt, hi0, ql, ks, vs)
    assert _row_err(got, want) <= 2**-7
    dead = np.arange(nq_tok)[None, :] >= ql[:, None]
    assert float(np.abs(got[dead]).max(initial=0.0)) == 0.0
    assert float(np.abs(want[dead]).max(initial=0.0)) == 0.0


def test_tiled_reference_bf16q_int8_rounds_p(rng):
    """The int8 tensor-core walk rounds P' = P * s_v to bf16: its model
    differs from the fp32 walk over the same bf16 q values and codes (fp32
    q over the int8 pool, which the kernel computes on the CUDA cores),
    by more than fp32 rounding and within the bf16 row tolerance."""
    q, k, v, pt, hi0, ql, ks, vs = _edge_slots(rng, 13, "bf16q_int8")
    tc = _tiled(q, k, v, pt, hi0, ql, ks, vs, "bf16q_int8")
    fp = _tiled(q, k, v, pt, hi0, ql, ks, vs, "int8")
    err = _row_err(tc, fp)
    assert 1e-4 < err <= 2**-7


# --------------------------------------------------------------------------
# decode_step_spec_paged
# --------------------------------------------------------------------------

N_PAGES = 12


@pytest.fixture(scope="module")
def weights():
    pj = jtfm.init_params(jtiny(), jax.random.PRNGKey(11))
    return pj, params_from_numpy(jax.tree.map(np.asarray, pj), device="cpu")


def _pools(rng, int8):
    """One random pool for both packages (the port's has one more, trash,
    page)."""
    cfg = jtiny()
    shape = (cfg.n_layers, N_PAGES, PS, cfg.n_kv_heads, cfg.head_dim)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 0.01).astype(np.float32)
        vs = (np.abs(rng.standard_normal(shape[:-1])) * 0.02 + 0.01).astype(np.float32)
        jc = jtfm.PagedKVCache(
            k=jnp.asarray(k), v=jnp.asarray(v), k_scale=jnp.asarray(ks, jnp.bfloat16),
            v_scale=jnp.asarray(vs, jnp.bfloat16), page_size=PS,
        )
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        jc = jtfm.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), page_size=PS)
    tc = ttfm.init_paged_kv_cache(
        ttiny(), N_PAGES, PS, dtype="int8" if int8 else torch.float32, device="cpu"
    )
    tc.k[:, :N_PAGES] = torch.from_numpy(k)
    tc.v[:, :N_PAGES] = torch.from_numpy(v)
    if int8:
        tc.k_scale[:, :N_PAGES] = torch.from_numpy(ks).to(torch.bfloat16)
        tc.v_scale[:, :N_PAGES] = torch.from_numpy(vs).to(torch.bfloat16)
    return jc, tc


def _real_pages(tc):
    out = [tc.k[:, :N_PAGES], tc.v[:, :N_PAGES]]
    if tc.quantized:
        out += [tc.k_scale[:, :N_PAGES], tc.v_scale[:, :N_PAGES]]
    return [a.float().numpy() for a in out]


def _jax_pages(jc):
    out = [jc.k, jc.v] + ([jc.k_scale, jc.v_scale] if jc.quantized else [])
    return [np.asarray(a.astype(jnp.float32)) for a in out]


def _replay_batch():
    """The resume replay's shape: 4 slots of Q=5.  Slot 0 replays 5
    tokens at 6..10 (across its page boundary); slot 1 replays 2 at 3..4,
    its 3 dead queries addressing positions 5..7 of its MAPPED page;
    slot 2 has q_lens 0 over a mapped page; slot 3 replays 1 at 30, its
    dead queries past the table."""
    pt = np.full((4, MP), N_PAGES, np.int32)
    pt[0, :2] = (4, 9)
    pt[1, 0] = 2
    pt[2, 0] = 6
    pt[3] = (0, 7, 3, 10)
    write_pos0 = np.array([6, 3, 0, 30], np.int32)
    ql = np.array([5, 2, 0, 1], np.int32)
    tokens = np.arange(4 * Q, dtype=np.int32).reshape(4, Q) + 20
    positions = write_pos0[:, None] + np.arange(Q)[None, :]
    return tokens, positions.astype(np.int32), pt, write_pos0, ql


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_spec_paged_matches_jax(weights, rng, int8):
    pj, pt_ = weights
    jc, tc = _pools(rng, int8)
    tokens, positions, pt, wp0, ql = _replay_batch()
    before = _real_pages(tc)
    lj, jc = jtfm.decode_step_spec_paged(
        pj, jtiny(), jnp.asarray(tokens), jnp.asarray(positions), jc,
        jnp.asarray(pt), jnp.asarray(wp0), q_lens=jnp.asarray(ql),
    )
    lt, tc = ttfm.decode_step_spec_paged(
        pt_, ttiny(), torch.from_numpy(tokens), torch.from_numpy(positions), tc,
        torch.from_numpy(pt), torch.from_numpy(wp0), q_lens=torch.from_numpy(ql),
    )
    assert lt.dtype == torch.float32 and tuple(lt.shape) == (4, Q, jtiny().vocab_size)
    live = np.arange(Q)[None, :] < ql[:, None]
    np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live], atol=1e-5, rtol=0)
    assert np.isfinite(lt.numpy()).all()
    after = _real_pages(tc)
    for got, want in zip(after, _jax_pages(jc)):
        if int8 and np.abs(want).max() > 2:
            # int8 codes: a fresh value on a rounding edge may quantize
            # one step apart; everything else is identical.
            assert np.abs(got - want).max() <= 1
            assert np.mean(got == want) > 0.999
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-2 if int8 else 0)
    # Dead queries wrote nothing: slot 1's positions 5..7 (page 2) and
    # slot 2's page 6 are as they were.
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a[:, 2, 5:], b[:, 2, 5:])
        np.testing.assert_array_equal(a[:, 6], b[:, 6])
