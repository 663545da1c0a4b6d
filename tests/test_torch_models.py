"""The port's TextEncoder and WeightGenerator against the JAX package's,
with the same weights carried across by ``convert``, at f32 atol 3e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu import HyperGNN as JaxHyperGNN
from graph_hypernetwork_forge_tpu.models import text_encoder as jte
from graph_hypernetwork_forge_tpu.models import weight_generator as jwg
from graph_hypernetwork_forge_tpu.utils.text import tokenize_texts
from graph_hypernetwork_forge_tpu_torch.convert import (
    text_encoder_from_jax,
    weight_generator_from_jax,
)
from graph_hypernetwork_forge_tpu_torch.models import text_encoder as pte
from graph_hypernetwork_forge_tpu_torch.models import weight_generator as pwg
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNN
from graph_hypernetwork_forge_tpu_torch.utils.initializers import layer_norm_apply

ATOL = 3e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_text_encoder_matches():
    cfg = jte.TextEncoderConfig(text_dim=64, char_emb_dim=32)
    jparams = jte.init_text_encoder(cfg, jax.random.PRNGKey(0))
    texts = ["knows", "", "works at", "ünïcode ☃", "a much longer relation text"]
    char_ids, lengths = tokenize_texts(texts)
    want = jte.apply_text_encoder(jparams, jnp.asarray(char_ids), jnp.asarray(lengths))
    got = pte.apply_text_encoder(
        text_encoder_from_jax(_numpy_tree(jparams)),
        torch.from_numpy(char_ids), torch.from_numpy(lengths),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("num_hidden", [0, 2])
@pytest.mark.parametrize("batched", [False, True])
def test_weight_generator_matches(num_hidden, batched):
    cfg = dict(text_dim=32, d_in=16, d_out=24, hidden_dim=64, num_hidden=num_hidden)
    jcfg, pcfg = jwg.WeightGeneratorConfig(**cfg), pwg.WeightGeneratorConfig(**cfg)
    jparams = jwg.init_weight_generator(jcfg, jax.random.PRNGKey(1))
    # Scale 1 instead of the 0.01 init, so the outputs are of order 1.
    jparams["log_scales"] = {k: jnp.zeros((1,)) for k in jparams["log_scales"]}
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((5, 32) if batched else (32,)).astype(np.float32)
    want = jwg.apply_weight_generator(jcfg, jparams, jnp.asarray(emb))
    got = pwg.apply_weight_generator(
        pcfg, weight_generator_from_jax(_numpy_tree(jparams)), torch.from_numpy(emb)
    )
    assert set(got) == {"W_msg", "W_self", "bias"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), rtol=0, atol=ATOL
        )


def test_weight_generator_init_distributions():
    cfg = pwg.WeightGeneratorConfig(text_dim=32, d_in=16, d_out=16, hidden_dim=64)
    params = pwg.init_weight_generator(cfg, torch.Generator().manual_seed(0))
    for name in ("W_msg", "W_self", "bias"):
        head = params["heads"][name][-1]
        assert not head["b"].any()
        assert abs(float(head["w"].std()) - 0.01) < 0.002
        assert torch.allclose(params["log_scales"][name], torch.log(torch.tensor([0.01])))
        hidden = params["heads"][name][0]["w"]
        assert float(hidden.abs().max()) <= 1 / np.sqrt(32)


@pytest.mark.parametrize("bad", [dict(text_dim=0), dict(d_in=-1), dict(d_out=0)])
def test_weight_generator_rejects_non_positive_dims(bad):
    cfg = dict(text_dim=8, d_in=8, d_out=8) | bad
    with pytest.raises(ValueError):
        jwg.WeightGeneratorConfig(**cfg)
    with pytest.raises(ValueError):
        pwg.WeightGeneratorConfig(**cfg)


def test_weight_generator_training_dropout_waits_for_the_training_slice():
    # Training-mode dropout needs an explicit generator (JAX: an rng key);
    # given one, it draws masks, and eval mode ignores it.
    cfg = pwg.WeightGeneratorConfig(text_dim=8, d_in=4, d_out=4, dropout=0.1)
    params = pwg.init_weight_generator(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="Generator"):
        pwg.apply_weight_generator(cfg, params, torch.zeros(8), train=True)
    emb = torch.ones(8)
    a, b = (pwg.apply_weight_generator(cfg, params, emb, train=True,
                                       gen=torch.Generator().manual_seed(s))
            for s in (1, 2))
    assert not torch.equal(a["W_msg"], b["W_msg"])
    c = pwg.apply_weight_generator(cfg, params, emb, gen=torch.Generator())
    torch.testing.assert_close(c["W_msg"], pwg.apply_weight_generator(cfg, params, emb)["W_msg"])


def test_wrappers_run_on_cpu_when_asked():
    gen = pwg.WeightGenerator(text_dim=64, d_in=32, d_out=32, device="cpu")
    out = gen(np.random.default_rng(0).standard_normal(64).astype(np.float32))
    assert out["W_msg"].shape == (32, 32) and out["bias"].shape == (32,)
    assert gen.num_parameters() == jwg.WeightGenerator(
        text_dim=64, d_in=32, d_out=32
    ).num_parameters()
    enc = pte.TextEncoder(text_dim=16, device="cpu")
    assert enc(["knows", ""]).shape == (2, 16)
    assert enc.encode_one("knows").shape == (16,)


def test_demo_config_parameter_count():
    port = HyperGNN(text_dim=64, node_feat_dim=16, hidden_dim=32, num_layers=2,
                    device="cpu")
    jax_model = JaxHyperGNN(text_dim=64, node_feat_dim=16, hidden_dim=32, num_layers=2)
    assert port.num_parameters() == jax_model.num_parameters() == 692_518
    assert sum(p.numel() for p in port.parameters()) == 692_518


def test_layer_norm_uses_biased_variance_with_eps_inside():
    x = torch.tensor([[1.0, 2.0, 4.0, 7.0]])
    p = {"g": torch.ones(4), "b": torch.zeros(4)}
    want = torch.nn.functional.layer_norm(x, (4,), eps=1e-5)
    torch.testing.assert_close(layer_norm_apply(p, x), want, rtol=0, atol=1e-6)
