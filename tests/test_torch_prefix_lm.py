"""The port's prefix-LM (paligemma-3b) held against the JAX package.

With ``device="cpu"`` and the same JAX-initialised parameters (carried
over by ``repro_torch.convert``) and batches (both pipelines draw the
tokens and the patch prefix ``prefix_embeds`` from one numpy seed):

* paligemma-3b at ``smoke_variant`` (a 4-patch prefix): the parameter
  tree and the fields, fp32 forward logits (over prefix and text), the
  loss over the text positions alone and every gradient leaf
  (``tests/test_torch_model_zoo.py``'s tolerances); prefill then decode
  at positions after the prefix, against the reference's caches and
  logits (``rtol=atol=1e-5``) and the port's forward (``atol=1e-4``);
  greedy tokens equal to the reference's after a 20-token prompt and
  after a 2,100-token one (past 2,048: the blocked path with the prefix
  mask, the plain version of the kernel here).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import engine as JE  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenPipeline  # noqa: E402
from repro_torch.serving import engine as TE  # noqa: E402

from test_torch_model_zoo import _batches, _configs, _params  # noqa: E402
from test_torch_model_zoo_recurrent import (  # noqa: E402
    check_decode, check_forward_loss_and_grads, check_greedy,
    check_tree_and_fields)

NAME = "paligemma-3b"


def test_param_tree_and_fields_match_reference():
    check_tree_and_fields(NAME)


def test_float32_forward_loss_and_grads_match_reference():
    """The logits cover the 4 prefix positions and the text; the loss
    scores the text alone."""
    check_forward_loss_and_grads(NAME, seed=31)


def test_prefill_then_decode_matches_reference_and_forward():
    check_decode(NAME, prompt=20, n_new=8, seed=32)


def test_greedy_tokens_equal_reference():
    check_greedy(NAME, seed=33)


def test_greedy_tokens_past_the_direct_path_equal_reference():
    """4 + 2,100 positions: the prefill's attention is the blocked path
    with the prefix mask in both packages."""
    jcfg, cfg = _configs(NAME)
    jparams, params = _params(jcfg, 34)
    jb, tb = _batches(jcfg, cfg, 2100, 35)
    jb = {k: v[:1] for k, v in jb.items()}
    tb = {k: v[:1] for k, v in tb.items()}
    want = np.asarray(JE.greedy_generate(jcfg, jparams, jb, 3))
    got = TE.greedy_generate(cfg, params, tb, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pipeline_draws_the_prefix_in_the_reference_order():
    _jcfg, cfg = _configs(NAME)
    b = SyntheticTokenPipeline(cfg, 2, 8, seed=1).next_batch()
    assert sorted(b) == ["prefix_embeds", "tokens"]
    assert b["prefix_embeds"].shape == (2, 4, cfg.d_model)
    assert b["prefix_embeds"].dtype == np.float32
