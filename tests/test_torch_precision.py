"""``precision=`` where the JAX package takes it: the port's
``linear_apply``, ``apply_text_encoder`` and the weight generator (through
``WeightGeneratorConfig.precision``, which ``HyperGNNConfig`` passes on)
take "highest" and "default", agree with JAX's at f32 atol 3e-5 at each,
and refuse a precision JAX does not know."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu.models import hypergnn as jhg
from graph_hypernetwork_forge_tpu.models import text_encoder as jte
from graph_hypernetwork_forge_tpu.models import weight_generator as jwg
from graph_hypernetwork_forge_tpu.utils import initializers as jinit
from graph_hypernetwork_forge_tpu.utils.text import tokenize_texts
from graph_hypernetwork_forge_tpu_torch.convert import (
    text_encoder_from_jax,
    weight_generator_from_jax,
)
from graph_hypernetwork_forge_tpu_torch.models import hypergnn as phg
from graph_hypernetwork_forge_tpu_torch.models import text_encoder as pte
from graph_hypernetwork_forge_tpu_torch.models import weight_generator as pwg
from graph_hypernetwork_forge_tpu_torch.utils import initializers as pinit

ATOL = 3e-5
PRECISIONS = ["highest", "default"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_linear_apply(precision):
    params = _np(jinit.linear_params(jax.random.PRNGKey(0), 24, 16))
    x = np.random.default_rng(0).standard_normal((7, 24)).astype(np.float32)
    want = jinit.linear_apply(params, jnp.asarray(x),
                              precision=jinit.resolve_precision(precision))
    got = pinit.linear_apply({k: torch.tensor(v) for k, v in params.items()},
                             torch.from_numpy(x), precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_apply_text_encoder(precision):
    jparams = jte.init_text_encoder(jte.TextEncoderConfig(text_dim=32), jax.random.PRNGKey(1))
    ids, lens = tokenize_texts(["knows", "", "works at", "a longer relation text"])
    want = jte.apply_text_encoder(jparams, jnp.asarray(ids), jnp.asarray(lens),
                                  precision=precision)
    got = pte.apply_text_encoder(text_encoder_from_jax(_np(jparams)), torch.from_numpy(ids),
                                 torch.from_numpy(lens), precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_weight_generator_and_hypergnn_config(precision):
    cfg = dict(text_dim=16, d_in=8, d_out=12, hidden_dim=32, precision=precision)
    jcfg, pcfg = jwg.WeightGeneratorConfig(**cfg), pwg.WeightGeneratorConfig(**cfg)
    jparams = jwg.init_weight_generator(jcfg, jax.random.PRNGKey(2))
    jparams["log_scales"] = {k: jnp.zeros((1,)) for k in jparams["log_scales"]}
    emb = np.random.default_rng(2).standard_normal((5, 16)).astype(np.float32)
    want = jwg.apply_weight_generator(jcfg, jparams, jnp.asarray(emb))
    got = pwg.apply_weight_generator(pcfg, weight_generator_from_jax(_np(jparams)),
                                     torch.from_numpy(emb))
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0,
                                   atol=ATOL, err_msg=name)
    hg = dict(text_dim=16, node_feat_dim=8, hidden_dim=8, precision=precision)
    assert (phg.HyperGNNConfig(**hg).weight_generator.precision
            == jhg.HyperGNNConfig(**hg).weight_generator.precision == precision)


def test_unknown_precision_is_refused():
    lin = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    with pytest.raises(ValueError, match="precision"):
        pinit.linear_apply(lin, torch.ones(1, 3), precision="fastest")
    te = pte.init_text_encoder(pte.TextEncoderConfig(text_dim=8), torch.Generator())
    ids, lens = tokenize_texts(["a"])
    with pytest.raises(ValueError, match="precision"):
        pte.apply_text_encoder(te, torch.from_numpy(ids), torch.from_numpy(lens),
                               precision="bf16")
    cfg = pwg.WeightGeneratorConfig(text_dim=4, d_in=2, d_out=2, precision="tf32")
    params = pwg.init_weight_generator(cfg, torch.Generator())
    with pytest.raises(ValueError, match="precision"):
        pwg.apply_weight_generator(cfg, params, torch.ones(4))
