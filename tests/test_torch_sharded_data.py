"""The port's sharded data plane against the JAX package's on the same
inputs (the host-logic twins of `tests/test_sharded_data.py`): shard
tags through select, split and gather, `shard_blocks`, the sharded
`split_balanced` and its shrink, `split_sharded`'s micro-batches and
blocks, `pack_sample`'s shard-aligned row blocks, and the PPO actor's and
critic's sharded branches on a member's zero-filled view (with a capture
engine whose `masked_moments` returns the full batch's moments, as the
JAX test does).  The engines' own reduction over real process groups is
in `tests/test_torch_sharding.py` and
`tests/test_torch_sharded_multiprocess.py`."""

import copy

import numpy as np
import pytest

from areal_tpu.api import data_api as jdata
from areal_tpu.engines import packing as jpacking
from areal_tpu.interfaces import ppo as jppo
from areal_tpu_torch.api import data_api as tdata
from areal_tpu_torch.engines import packing as tpacking
from areal_tpu_torch.interfaces import ppo as tppo
from tests.fixtures import zero_fill_unowned

PKG = {
    "jax": (jdata, jpacking),
    "torch": (tdata, tpacking),
}


def _tagged(data_api, n=8, n_shards=2, seed=0, tags=None):
    rng = np.random.default_rng(seed)
    lens = rng.integers(6, 20, size=n).tolist()
    toks = rng.integers(1, 50, size=sum(lens)).astype(np.int32)
    mask = rng.integers(0, 2, size=sum(lens)).astype(np.bool_)
    return data_api.SequenceSample(
        keys={"packed_input_ids", "prompt_mask"},
        ids=[f"s{i}" for i in range(n)],
        seqlens={k: [[int(l)] for l in lens] for k in ("packed_input_ids", "prompt_mask")},
        data={"packed_input_ids": toks, "prompt_mask": mask},
        metadata={"shard_of": tags or [[i % n_shards, n_shards] for i in range(n)]},
    )


def _both(**kw):
    return {name: _tagged(mods[0], **kw) for name, mods in PKG.items()}


@pytest.mark.parametrize("n,n_shards", [(6, 2), (9, 3), (4, 4), (5, 1)])
def test_shard_blocks_match_jax(n, n_shards):
    s = _both(n=n, n_shards=n_shards)
    assert s["torch"].shard_blocks() == s["jax"].shard_blocks()
    if n_shards > 1:
        assert s["torch"].shard_blocks()[0] == list(range(0, n, n_shards))
    else:
        assert s["torch"].shard_blocks() is None


def test_untagged_and_inconsistent_tags():
    s = _both(n=4)
    for v in s.values():
        v.metadata.pop("shard_of")
        assert v.shard_blocks() is None
    bad = _both(n=4, tags=[[0, 2], [1, 2], [0, 3], [1, 2]])
    for v in bad.values():
        with pytest.raises(ValueError, match="inconsistent"):
            v.shard_blocks()


def test_tags_survive_select_split_and_gather():
    s = _both(n=8)
    for name, v in s.items():
        sub = v.select_idx([1, 2, 5])
        assert sub.metadata["shard_of"] == [[1, 2], [0, 2], [1, 2]]
        parts = v.split_balanced(2)
        for mb in parts:
            assert mb.shard_blocks() is not None and len(mb.shard_blocks()) == 2
        back = type(v).gather(parts)
        assert sorted(back.ids) == sorted(v.ids)
        for i, t in zip(back.ids, back.metadata["shard_of"]):
            assert t[0] == int(i[1:]) % 2
    for j, t in zip(s["jax"].split(tdata.MicroBatchSpec(max_tokens_per_mb=30)),
                    s["torch"].split(tdata.MicroBatchSpec(max_tokens_per_mb=30))):
        assert (t.ids, t.metadata) == (j.ids, j.metadata)


@pytest.mark.parametrize("n,k,tags", [
    (8, 2, None),
    (8, 3, None),
    (6, 4, None),  # every shard smaller than k: k shrinks to 3
    (8, 4, [[0, 2]] * 6 + [[1, 2]] * 2),  # one big shard keeps k
    (9, 2, [[i % 3, 3] for i in range(9)]),
])
def test_split_balanced_matches_jax(n, k, tags):
    s = _both(n=n, tags=tags)
    got = [p.ids for p in s["torch"].split_balanced(k)]
    assert got == [p.ids for p in s["jax"].split_balanced(k)]
    assert sorted(i for p in got for i in p) == sorted(s["torch"].ids)
    assert all(got)


@pytest.mark.parametrize("mb_spec", [
    dict(), dict(max_tokens_per_mb=48), dict(n_mbs=3), dict(n_mbs=2, max_tokens_per_mb=40),
])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_split_sharded_matches_jax(mb_spec, n_shards):
    s = _both(n=10, n_shards=n_shards, seed=3)
    j = jpacking.split_sharded(s["jax"], jdata.MicroBatchSpec(**mb_spec))
    t = tpacking.split_sharded(s["torch"], tdata.MicroBatchSpec(**mb_spec))
    assert [(mb.ids, b) for mb, b in t] == [(mb.ids, b) for mb, b in j]


@pytest.mark.parametrize("rows_multiple", [1, 2, 4, 8])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pack_sample_shard_blocks_match_jax(rows_multiple, n_shards):
    s = _both(n=8, n_shards=n_shards, seed=1)
    blocks = s["torch"].shard_blocks()
    kw = dict(extra_keys=("prompt_mask",), max_tokens_per_row=32,
              n_rows_multiple=rows_multiple, shard_blocks=blocks)
    j = jpacking.pack_sample(s["jax"], "packed_input_ids", **kw)
    t = tpacking.pack_sample(s["torch"], "packed_input_ids", **kw)
    assert t.seq_map == j.seq_map and (t.n_rows, t.row_len) == (j.n_rows, j.row_len)
    assert t.n_rows % rows_multiple == 0
    for k in j.arrays:
        np.testing.assert_array_equal(t.arrays[k], j.arrays[k])
    np.testing.assert_array_equal(t.unpack(t.arrays["tokens"]), s["torch"].data["packed_input_ids"])
    if blocks:
        per = t.n_rows // len(blocks)
        for shard, block in enumerate(blocks):
            assert all(shard * per <= t.seq_map[i][0] < (shard + 1) * per for i in block)


def test_layout_derivable_from_metadata_alone():
    """Members holding different data for other shards' rows derive the
    same split and pack layout from the lengths and tags alone."""
    a = _tagged(tdata, n=10, seed=3)
    b = _tagged(tdata, n=10, seed=3)
    b.data["packed_input_ids"] = np.zeros_like(b.data["packed_input_ids"])
    mb_spec = tdata.MicroBatchSpec(max_tokens_per_mb=48)
    sa, sb = tpacking.split_sharded(a, mb_spec), tpacking.split_sharded(b, mb_spec)
    assert len(sa) == len(sb)
    for (ma, ba), (mb_, bb) in zip(sa, sb):
        assert list(ma.ids) == list(mb_.ids) and ba == bb
        pa = tpacking.pack_sample(ma, "packed_input_ids", shard_blocks=ba, max_tokens_per_row=48)
        pb = tpacking.pack_sample(mb_, "packed_input_ids", shard_blocks=bb, max_tokens_per_row=48)
        assert pa.seq_map == pb.seq_map
        np.testing.assert_array_equal(pa.arrays["segment_ids"], pb.arrays["segment_ids"])


def test_shard_blocks_must_partition():
    for name, (data_api, packing) in PKG.items():
        s = _tagged(data_api, n=4)
        with pytest.raises(ValueError, match="partition"):
            packing.pack_sample(s, "packed_input_ids", shard_blocks=[[0, 1], [1, 2, 3]])


def test_group_rows_expand_to_sequence_blocks():
    """A PPO element holds `group` sequences: split_sharded's blocks index
    sequences, as the JAX package's do."""
    samples = {}
    for name, (data_api, _) in PKG.items():
        seqlens = [[5, 7], [6, 6], [8, 4], [3, 9]]
        total = sum(sum(r) for r in seqlens)
        samples[name] = data_api.SequenceSample(
            keys={"packed_input_ids"}, ids=[f"q{i}" for i in range(4)],
            seqlens={"packed_input_ids": seqlens},
            data={"packed_input_ids": np.arange(total, dtype=np.int32)},
            metadata={"shard_of": [[i % 2, 2] for i in range(4)]},
        )
    j = jpacking.split_sharded(samples["jax"], jdata.MicroBatchSpec())
    t = tpacking.split_sharded(samples["torch"], tdata.MicroBatchSpec())
    assert [b for _, b in t] == [b for _, b in j] == [[[0, 1, 2, 3], [4, 5, 6, 7]]]


# ---------------- the PPO interfaces' sharded branches ----------------


class _CaptureEngine:
    """train_batch records the minibatches; masked_moments returns the
    full batch's moments (the engines' reduction is tested over gloo)."""

    def __init__(self, data_api, oracle=None, device="cpu"):
        self.data_api, self.oracle, self.captured = data_api, oracle or {}, []
        self.device = device

    def train_batch(self, mb, mb_spec, **kw):
        self.captured.append(mb)
        return {}

    def masked_moments(self, sample, mb_spec, value_keys, mask_key="loss_mask"):
        out = {"count": self.oracle["count"]}
        for k in value_keys:
            out[k] = np.asarray(self.oracle[k], np.float64)
        return out

    def in_order(self, ids):
        merged = self.data_api.SequenceSample.gather(self.captured)
        pos = {i: n for n, i in enumerate(merged.ids)}
        return merged.select_idx([pos[i] for i in ids])


def _rollout(data_api, n_ids=4, group=2, seed=11, values=True):
    rng = np.random.default_rng(seed)
    seqlens = [[int(rng.integers(10, 18)) for _ in range(group)] for _ in range(n_ids)]
    flat = [l for row in seqlens for l in row]
    total, n_seqs = sum(flat), n_ids * group
    pmask = np.concatenate([np.r_[np.ones(p, bool), np.zeros(l - p, bool)]
                            for l, p in zip(flat, rng.integers(3, 6, size=len(flat)))])
    data = {
        "packed_input_ids": rng.integers(1, 64, size=total).astype(np.int32),
        "prompt_mask": pmask,
        "packed_logprobs": rng.normal(-1.0, 0.3, size=total - n_seqs).astype(np.float32),
        "packed_ref_logprobs": rng.normal(-1.1, 0.3, size=total - n_seqs).astype(np.float32),
        "values": rng.normal(0.0, 1.0, size=total).astype(np.float32),
        "rewards": rng.choice([-1.0, 1.0], size=n_seqs).astype(np.float32),
        "seq_no_eos_mask": np.zeros(n_seqs, np.float32),
    }
    seq = {
        "packed_input_ids": [list(r) for r in seqlens],
        "prompt_mask": [list(r) for r in seqlens],
        "values": [list(r) for r in seqlens],
        "packed_logprobs": [[l - 1 for l in r] for r in seqlens],
        "packed_ref_logprobs": [[l - 1 for l in r] for r in seqlens],
        "rewards": [[1] * group] * n_ids,
        "seq_no_eos_mask": [[1] * group] * n_ids,
    }
    if not values:
        data.pop("values")
        seq.pop("values")
    return data_api.SequenceSample(keys=set(data), ids=[f"q{i}" for i in range(n_ids)],
                                   seqlens=seq, data=data)


def _view(sample, rank, n_shards=2):
    view = copy.deepcopy(sample)
    zero_fill_unowned(view, rank, n_shards,
                      ("packed_input_ids", "packed_logprobs", "packed_ref_logprobs", "values"))
    view.metadata["shard_of"] = [[i % n_shards, n_shards] for i in range(view.bs)]
    return view


def _own(sample, rank, n_shards=2, key="packed_input_ids"):
    m = np.zeros(sample.total_len(key), bool)
    b = sample.cu_seqlens(key)
    for i in range(sample.bs):
        if i % n_shards == rank:
            s0 = sum(len(g) for g in sample.seqlens[key][:i])
            m[b[s0]: b[s0 + len(sample.seqlens[key][i])]] = True
    return m


def _actor(mod, **kw):
    from areal_tpu.api.model_api import GenerationHyperparameters as JG
    from areal_tpu_torch.api.model_api import GenerationHyperparameters as TG

    g = (JG if mod is jppo else TG)(n=2, max_new_tokens=8)
    base = dict(gconfig=g, n_minibatches=1, kl_ctl=0.15, adv_norm=True, disable_value=False,
                kl_adaptive=True, adaptive_kl_target=4.0, adaptive_kl_horizon=100.0)
    base.update(kw)
    return mod.PPOActorInterface(**base)


def _model(mod, engine):
    from areal_tpu.api.model_api import Model as JModel
    from areal_tpu_torch.api.model_api import Model as TModel

    return (JModel if mod is jppo else TModel)("m", engine=engine, tokenizer=None, config=None)


def _kl_value(iface):
    return iface._kl().value if hasattr(iface, "_kl") else iface._kl_ctl.value


def _oracle(pre_adv, klterm, mask):
    m = mask > 0

    def mom(x):
        return [float(x[m].sum()), float((x[m] ** 2).sum()), float(np.abs(x[m]).sum())]

    return {"count": float(m.sum()), "adv_probe": mom(pre_adv), "klterm": mom(klterm)}


@pytest.mark.parametrize("grpo", [False, True], ids=["critic_values", "grpo"])
def test_actor_sharded_branches_match_jax_and_full(grpo):
    """KL-in-reward, batch adv_norm and the adaptive controller on each
    member's zero-filled view: the member's own advantages, the ref-KL
    and the controller equal the full-data run's, in both packages."""
    stats, advs, kls = {}, {}, {}
    for mod, data_api in ((jppo, jdata), (tppo, tdata)):
        full = _rollout(data_api, seed=13 if grpo else 11, values=not grpo)
        kw = dict(disable_value=True) if grpo else {}
        pre = _CaptureEngine(data_api)
        mod_if = _actor(mod, adv_norm=False, kl_adaptive=False, **kw)
        mod_if.train_step(_model(mod, pre), full, data_api.MicroBatchSpec())
        pre_mb = pre.in_order(full.ids)
        loss_mask = np.asarray(pre_mb.data["loss_mask"])
        ref = mod._seq_align_minus1(full, "packed_ref_logprobs")
        oracle = _oracle(np.asarray(pre_mb.data["advantages"]),
                         (np.asarray(pre_mb.data["old_logp"]) - ref) * loss_mask, loss_mask)
        f_eng = _CaptureEngine(data_api)
        f_if = _actor(mod, **kw)
        f_stats = f_if.train_step(_model(mod, f_eng), full, data_api.MicroBatchSpec())
        f_adv = np.asarray(f_eng.in_order(full.ids).data["advantages"])
        for rank in (0, 1):
            s_eng = _CaptureEngine(data_api, oracle)
            s_if = _actor(mod, **kw)
            s_stats = s_if.train_step(_model(mod, s_eng), _view(full, rank),
                                      data_api.MicroBatchSpec())
            own = _own(full, rank)
            s_adv = np.asarray(s_eng.in_order(full.ids).data["advantages"])
            np.testing.assert_allclose(s_adv[own], f_adv[own], rtol=2e-5, atol=2e-6)
            assert s_stats["ref_kl"] == pytest.approx(f_stats["ref_kl"], rel=1e-5)
            assert _kl_value(s_if) == pytest.approx(_kl_value(f_if), rel=1e-6)
            stats[(mod.__name__, rank)] = s_stats["ref_kl"]
            advs[(mod.__name__, rank)] = s_adv[own]
            kls[(mod.__name__, rank)] = _kl_value(s_if)
    for rank in (0, 1):
        j, t = (jppo.__name__, rank), (tppo.__name__, rank)
        np.testing.assert_allclose(advs[t], advs[j], rtol=1e-5, atol=1e-6)
        assert stats[t] == pytest.approx(stats[j], rel=1e-6)
        assert kls[t] == pytest.approx(kls[j], rel=1e-9)


@pytest.mark.parametrize("kind", ["exp", "ma"])
def test_critic_value_norm_sharded_moments_match_jax(kind):
    """The critic's running value-norm moments ride `masked_moments`:
    every member ends with the full run's state, in both packages."""
    states = {}
    for mod, data_api in ((jppo, jdata), (tppo, tdata)):
        full = _rollout(data_api, seed=17)

        def run(iface, sample, engine):
            iface.train_step(_model(mod, engine), sample, data_api.MicroBatchSpec())
            return iface

        crit = lambda vn: mod.PPOCriticInterface(n_minibatches=1, value_norm=vn,
                                                 value_norm_type=kind)
        f_eng = _CaptureEngine(data_api)
        f_state = run(crit(True), full, f_eng).state_dict()
        f_mb = f_eng.in_order(full.ids)
        m = np.asarray(f_mb.data["loss_mask"]) > 0
        p_eng = _CaptureEngine(data_api)
        run(crit(False), full, p_eng)
        pre = np.asarray(p_eng.in_order(full.ids).data["returns"])
        oracle = {"count": float(m.sum()),
                  "ret_probe": [float(pre[m].sum()), float((pre[m] ** 2).sum()),
                                float(np.abs(pre[m]).sum())]}
        for rank in (0, 1):
            s_eng = _CaptureEngine(data_api, oracle)
            s_state = run(crit(True), _view(full, rank), s_eng).state_dict()
            for k, v in f_state.items():
                assert s_state[k] == pytest.approx(v, rel=1e-5), (rank, k)
            own = _own(full, rank)
            np.testing.assert_allclose(
                np.asarray(s_eng.in_order(full.ids).data["returns"])[own],
                np.asarray(f_mb.data["returns"])[own], rtol=2e-5, atol=2e-6)
            states[(mod.__name__, rank)] = s_state
    for rank in (0, 1):
        j, t = states[(jppo.__name__, rank)], states[(tppo.__name__, rank)]
        for k in j:  # the packages' fp32 returns differ in the last bits
            assert t[k] == pytest.approx(j[k], rel=1e-6), k


def test_best_of_k_keeps_tags_and_packs():
    rng = np.random.default_rng(5)
    n_ids, gsize = 4, 3
    seqlens = [[8, 9, 10] for _ in range(n_ids)]
    total = sum(sum(r) for r in seqlens)
    pmask = np.zeros(total, bool)
    off = 0
    for l in (x for r in seqlens for x in r):
        pmask[off: off + 3] = True
        off += l
    data = {"packed_input_ids": rng.integers(1, 50, total).astype(np.int32),
            "prompt_mask": pmask, "rewards": rng.normal(size=n_ids * gsize).astype(np.float32)}
    kept = {}
    for mod, data_api in ((jppo, jdata), (tppo, tdata)):
        s = data_api.SequenceSample(
            keys=set(data), ids=[f"q{i}" for i in range(n_ids)],
            seqlens={"packed_input_ids": [list(r) for r in seqlens],
                     "prompt_mask": [list(r) for r in seqlens],
                     "rewards": [[1] * gsize] * n_ids},
            data={k: v.copy() for k, v in data.items()},
            metadata={"shard_of": [[i % 2, 2] for i in range(n_ids)]},
        )
        iface = _actor(mod, generation_size=gsize)
        kept[mod.__name__] = k = iface._filter_best_of_k(s)
        assert k.metadata["shard_of"] == s.metadata["shard_of"]
        assert all(len(g) == 2 for g in k.seqlens["packed_input_ids"])
    t, j = kept[tppo.__name__], kept[jppo.__name__]
    np.testing.assert_array_equal(t.data["packed_input_ids"], j.data["packed_input_ids"])
    for mb, blocks in tpacking.split_sharded(t, tdata.MicroBatchSpec()):
        pk = tpacking.pack_sample(mb, "packed_input_ids", extra_keys=("prompt_mask",),
                                  n_rows_multiple=2, shard_blocks=blocks)
        assert pk.n_rows >= 2 and pk.n_rows % 2 == 0


def test_streams_refuse_shard_tags():
    """A stream's chunks go to every member whole, as in the JAX package."""
    full = _rollout(tdata)
    view = _view(full, 0)
    for iface in (_actor(tppo), tppo.PPOCriticInterface(n_minibatches=1)):
        state = {"stopped": False, "engine": None, "chunk_stats": []}
        with pytest.raises(ValueError, match="shard-exact"):
            iface.train_stream_chunk(_model(tppo, _CaptureEngine(tdata)), state, view,
                                     tdata.MicroBatchSpec())
