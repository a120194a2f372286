"""SFT in the port against the JAX package, on the CPU in fp32: the
answer-only loss and its host-side label count (the two must count the
same positions, or the gradient is mis-weighted silently), the
`prompt_answer` dataset, `SFTInterface.train_step` and `evaluate` on
one set of weights, and one `quickstart sft` trial through both CLIs
from one checkpoint (twin of tests/test_quickstart_cli.py's SFT case)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.api.data_api import MicroBatchSpec as JMicroBatchSpec
from areal_tpu.api.model_api import Model as JModel
from areal_tpu.data import datasets as jdatasets
from areal_tpu.interfaces.sft import SFTInterface as JSFTInterface
from areal_tpu.models import transformer as jtfm
from areal_tpu.models.config import tiny_config as jtiny
from areal_tpu.models.hf import registry as jhf
from areal_tpu.ops import functional as jF
from areal_tpu_torch.api.data_api import MicroBatchSpec
from areal_tpu_torch.api.model_api import Model
from areal_tpu_torch.apps import quickstart
from areal_tpu_torch.data import datasets
from areal_tpu_torch.data.tokenizer import CharTokenizer
from areal_tpu_torch.interfaces.sft import SFTInterface
from areal_tpu_torch.models.config import tiny_config as ttiny
from areal_tpu_torch.models.hf import registry as hf
from areal_tpu_torch.models.weights import params_to_numpy
from areal_tpu_torch.ops import functional as tF
from tests.test_torch_sentinels import _engines
from tests.test_torch_train import _flat, _samples

torch.set_num_threads(2)


def _packed(rng, rows):
    """Dense packed arrays: `rows` lists each row's segments as (length,
    prompt tokens); a row's tail past its segments is padding."""
    s = max(sum(n for n, _ in r) for r in rows) + 3
    seg = np.zeros((len(rows), s), np.int32)
    pm = np.zeros((len(rows), s), bool)
    for i, r in enumerate(rows):
        off = 0
        for j, (n, p) in enumerate(r):
            seg[i, off:off + n] = j + 1
            pm[i, off:off + p] = True
            off += n
    logp = (-3.0 * rng.random((len(rows), s))).astype(np.float32)
    return seg, pm, logp


LAYOUTS = {
    # A segment that is all prompt (its last prompt token ends it), one
    # whose answer is a single token, and a plain one, packed in a row.
    "all_prompt_then_answers": [[(5, 5), (4, 3), (7, 2)]],
    "prompt_ends_row": [[(6, 2), (3, 3)], [(4, 1)]],
    "one_token_segments": [[(1, 1), (1, 0), (2, 1), (5, 5)]],
    "no_prompt": [[(8, 0), (6, 0)], [(3, 0)]],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sft_loss_and_label_count_match_jax(rng, layout):
    """nll_sum, n_tokens and the label count: 1e-6 of JAX's, and the
    label count equal to the loss's own n_tokens (when positive)."""
    seg, pm, logp = _packed(rng, LAYOUTS[layout])
    want_loss, want_stats = jF.sft_loss(
        jnp.asarray(logp), {"segment_ids": jnp.asarray(seg), "prompt_mask": jnp.asarray(pm)})
    got_loss, got_stats = tF.sft_loss(
        torch.from_numpy(logp), {"segment_ids": torch.from_numpy(seg),
                                 "prompt_mask": torch.from_numpy(pm)})
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-6)
    for k in want_stats:
        np.testing.assert_allclose(float(got_stats[k]), float(want_stats[k]), rtol=1e-6,
                                   err_msg=k)
    arrays = {"segment_ids": seg, "prompt_mask": pm}
    count = tF.sft_label_count(arrays)
    assert count == jF.sft_label_count(arrays)
    assert max(count, 1.0) == float(got_stats["n_tokens"])


ROWS = [
    {"id": "a", "prompt": "What is 2+2? ", "answer": "4"},
    {"id": "b", "prompt": "Name a colour: ", "answer": "blue, or any other one at all"},
    {"id": "c", "prompt": "x" * 40, "answer": "cut off"},  # prompt past max_length
    {"id": "d", "prompt": "", "answer": "no prompt"},
]


@pytest.mark.parametrize("max_length", [24, 1024])
def test_prompt_answer_dataset_matches_jax(max_length):
    tok = CharTokenizer(512)
    kw = dict(seed=3, dp_rank=0, world_size=1, tokenizer=tok, max_length=max_length,
              dataset_builder=lambda: [dict(r) for r in ROWS])
    got = datasets.PromptAnswerDataset(**kw)
    want = jdatasets.PromptAnswerDataset(**kw)
    assert got.ids == want.ids and len(got) == len(ROWS)
    for i in range(len(got)):
        g, w = got[i], want[i]
        assert g.ids == w.ids and g.seqlens == w.seqlens
        for k in ("packed_input_ids", "prompt_mask"):
            np.testing.assert_array_equal(g.data[k], w.data[k], err_msg=k)
            assert g.data[k].dtype == w.data[k].dtype
        assert g.data["packed_input_ids"][-1] == tok.eos_token_id or max_length == 24


def _sft_batch(seed, n=6):
    rng = np.random.default_rng(seed)
    lens = [int(x) for x in rng.integers(5, 30, n)]
    arrays = dict(
        packed_input_ids=rng.integers(0, ttiny().vocab_size, sum(lens)).astype(np.int32),
        prompt_mask=np.concatenate([np.arange(l) < int(rng.integers(1, l)) for l in lens]),
    )
    return _samples(arrays, lens)


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, jtfm.init_params(jtiny(), jax.random.PRNGKey(4)))


def test_sft_interface_matches_jax(weights):
    """Two train steps (two micro-batches each) and then `evaluate` over
    two batches: the stats within 1e-5 (the norms 1e-4), the weights
    after each step within 1e-5 of JAX's, eval_nll within 1e-5."""
    je, te = _engines(weights, lr=1e-3)
    tok = CharTokenizer(512)
    tmodel, jmodel = Model("m", te, tok, ttiny()), JModel("m", je, tok, jtiny())
    for step in range(2):
        ts, js = _sft_batch(step)
        got = SFTInterface().train_step(tmodel, ts, MicroBatchSpec(n_mbs=2))
        want = JSFTInterface().train_step(jmodel, js, JMicroBatchSpec(n_mbs=2))
        assert set(got) == set(want) and tmodel.version == jmodel.version == step + 1
        for k in want:
            tol = 1e-4 if k.endswith("norm") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-7, err_msg=k)
        pj, pt = _flat(je.get_params()), _flat(params_to_numpy(te.get_params()))
        for k in pj:
            np.testing.assert_allclose(pt[k], pj[k], atol=1e-5, rtol=0, err_msg=k)
    evals = [_sft_batch(10 + i, n=3) for i in range(2)]
    got = SFTInterface().evaluate(tmodel, [t for t, _ in evals])
    want = JSFTInterface().evaluate(jmodel, [j for _, j in evals])
    np.testing.assert_allclose(got["eval_nll"], want["eval_nll"], rtol=1e-5)
    assert got["eval_nll"] > 0


def test_quickstart_sft_matches_jax(tmp_path, monkeypatch):
    """`quickstart sft` through both CLIs from one checkpoint the JAX
    package wrote (12 rows, batch 4, two micro-batches a step, a save
    at step 3): each step's loss, nll, grad and update norms within
    1e-4, and the saved checkpoints within 1e-4 (and moved)."""
    from areal_tpu.apps import quickstart as jquickstart

    jseen = []

    def run(*a, _real=jquickstart._run, **k):
        jseen.append(_real(*a, **k))
        return jseen[-1]

    monkeypatch.setattr(jquickstart, "_run", run)

    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, jtiny(), jtfm.init_params(jtiny(), jax.random.PRNGKey(1)),
                           model_type="qwen2")
    data = tmp_path / "sft.jsonl"
    rng = np.random.default_rng(2)
    with open(data, "w") as f:
        for i in range(12):
            a, b = (int(x) for x in rng.integers(1, 100, 2))
            f.write(json.dumps({"id": f"r{i}", "prompt": f"Q: {a} + {b} = ",
                                "answer": f"{a + b}. " * int(rng.integers(1, 4))}) + "\n")

    def argv(root):
        return ["sft", "--model.path", ckpt, "--dataset.path", str(data),
                "--tokenizer-path", "char:512", "--batch-size", "4", "--lr", "1e-3",
                "--max-tokens-per-mb", "48", "--save-freq-steps", "3",
                "--fileroot", str(root)]

    jquickstart.main(argv(tmp_path / "jax"))
    tstats = quickstart.main(argv(tmp_path / "port"), device="cpu")
    (jstats,) = jseen
    assert len(tstats) == len(jstats) == 3 and tstats[-1]["n_micro_batches"] >= 2
    for got, want in zip(tstats, jstats):
        for k in ("loss", "nll", "grad_norm", "update_norm", "n_tokens", "n_micro_batches"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    saved = [os.path.join(tmp_path, pkg, "checkpoints", "sft", "trial0", "default@0", "step_3")
             for pkg in ("port", "jax")]
    _, got = hf.load_hf_checkpoint(saved[0], dtype=torch.float32, device="cpu")
    _, want = hf.load_hf_checkpoint(saved[1], dtype=torch.float32, device="cpu")
    _, init = hf.load_hf_checkpoint(ckpt, dtype=torch.float32, device="cpu")
    fg, fw, fi = (_flat(params_to_numpy(t)) for t in (got, want, init))
    assert sorted(fg) == sorted(fw)
    for k in fw:
        np.testing.assert_allclose(fg[k], fw[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert max(float(np.abs(fg[k] - fi[k]).max()) for k in fi) > 1e-4
