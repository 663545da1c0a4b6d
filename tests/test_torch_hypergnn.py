"""The serving slice as a whole: the port's HyperGNN forward against the JAX
package's, per layer, at f32 atol 3e-5, with the same weights and graph.

The port's ``cuda`` backend runs the kernels' plain versions here on the
CPU; the JAX side runs its Pallas backends in interpret mode, as its own
tests do off the TPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_hypernetwork_forge_tpu import HyperGNN as JaxHyperGNN
from graph_hypernetwork_forge_tpu.data.encoding import encode_graph as jax_encode
from graph_hypernetwork_forge_tpu.models import hypergnn as jhg
from graph_hypernetwork_forge_tpu.ops import message_passing as jmp
from graph_hypernetwork_forge_tpu.ops import scoring as jscoring
from graph_hypernetwork_forge_tpu_torch.convert import params_from_jax
from graph_hypernetwork_forge_tpu_torch.data.encoding import encode_graph
from graph_hypernetwork_forge_tpu_torch.data.knowledge_graph import ToyKnowledgeGraph
from graph_hypernetwork_forge_tpu_torch.models import hypergnn as phg
from graph_hypernetwork_forge_tpu_torch.ops import scoring
from graph_hypernetwork_forge_tpu_torch.ops.message_passing import (
    relational_message_passing,
    resolve_backend,
)
from graph_hypernetwork_forge_tpu_torch.utils import profiling
from torch_cases import kernel_counts

ATOL = 3e-5
N, F, U, E = 48, 16, 5, 300


def _graph(seed=0):
    """Random graph; nodes N-4.. have no in-edges (isolated as targets)."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N, E), rng.integers(1, N - 4, E)])
    texts = [f"relation type {i} of the graph" for i in range(U)]
    etexts = [texts[i] for i in rng.integers(0, U, E)]
    feats = rng.standard_normal((N, F)).astype(np.float32)
    return feats, ei, etexts


def _jax_params(cfg, seed=0):
    params = jhg.init_hypergnn(cfg, jax.random.PRNGKey(seed))
    # Generated weights at scale 1 instead of the 0.01 init, so message
    # passing moves the output well beyond the residual.
    for g in params["weight_generators"]:
        g["log_scales"] = {k: jnp.zeros((1,)) for k in g["log_scales"]}
    return jax.tree_util.tree_map(np.asarray, params)


def _run_both(d, jax_backend, port_backend, layout):
    feats, ei, etexts = _graph()
    common = dict(text_dim=32, node_feat_dim=F, hidden_dim=d, num_layers=2)
    grouped = layout.get("group_pad", 0) > 0
    jcfg = jhg.HyperGNNConfig(
        **common, backend=jax_backend, rel_sorted=layout["sort_by_relation"],
        group_padded=grouped,
    )
    pcfg = phg.HyperGNNConfig(
        **common, backend=port_backend, rel_sorted=layout["sort_by_relation"],
        group_padded=grouped,
    )
    jparams = _jax_params(jcfg)
    jg = jax_encode(ei, etexts, N, **layout)
    pg = encode_graph(ei, etexts, N, **layout)
    want = jhg.apply_hypergnn(
        jcfg, jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(feats),
        *(jnp.asarray(a) for a in jg.arrays), return_all_layers=True,
        sort_plan=jax.tree_util.tree_map(jnp.asarray, jg.sort_plan),
    )
    got = phg.apply_hypergnn(
        pcfg, params_from_jax(jparams), torch.from_numpy(feats),
        *(torch.from_numpy(a) for a in pg.arrays), return_all_layers=True,
        sort_plan=None if pg.sort_plan is None else pg.sort_plan.to("cpu"),
    )
    return got, want


_KERNEL_LAYOUT = dict(sort_by_relation=True, with_sort_plan=True, group_pad=256)


@pytest.mark.parametrize(
    "d,jax_backend",
    [(128, "pallas"), (64, "pallas"), (64, "pallas_packed")],
)
def test_cuda_backend_matches_jax_kernel_backends_per_layer(d, jax_backend):
    with profiling.tally() as counts:
        got, want = _run_both(d, jax_backend, "cuda", _KERNEL_LAYOUT)
        assert len(got) == len(want) == 2
        for layer, (g, w) in enumerate(zip(got, want)):
            assert g.shape == (N, d)
            np.testing.assert_allclose(
                g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=f"layer {layer}"
            )
    # The plain versions ran: CPU tensors launch nothing.
    assert not kernel_counts(counts), counts


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize(
    "layout", [dict(sort_by_relation=False), _KERNEL_LAYOUT],
    ids=["stored-order", "group-padded"],
)
def test_gather_oracle_matches_jax_gather_per_layer(d, layout):
    got, want = _run_both(d, "gather", "gather", layout)
    for layer, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=0, atol=ATOL, err_msg=f"layer {layer}"
        )


def test_isolated_nodes_and_masked_pad_rows_give_exact_zero():
    # Pad rows point at node 0 with mask 0; node 0 and the last 4 nodes have
    # no real in-edges, so their pre-residual rows must be exactly zero.
    rng = np.random.default_rng(1)
    feats, ei, etexts = _graph(1)
    g = encode_graph(ei, etexts, N, **_KERNEL_LAYOUT)
    assert (g.edge_mask == 0).any() and (g.dst[g.edge_mask == 0] == 0).all()
    d = 16
    u_pad = g.char_ids.shape[0]
    h = torch.from_numpy(rng.standard_normal((N, d)).astype(np.float32))
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((u_pad, d, d), (u_pad, d, d), (u_pad, d))]
    src, dst, rel, mask = (torch.from_numpy(a) for a in g.arrays[:4])
    isolated = [0] + list(range(N - 4, N))
    for backend in ("cuda", "gather"):
        out = relational_message_passing(
            h, src, dst, rel, *w, edge_mask=mask, backend=backend,
            rel_sorted=True, group_padded=True, sort_plan=g.sort_plan.to("cpu"),
        )
        assert not out[isolated].any(), backend
        assert out[1:N - 4].abs().sum(dim=1).min() > 0, backend


def test_score_functions_match_jax():
    rng = np.random.default_rng(2)
    embs = rng.standard_normal((N, 32)).astype(np.float32)
    src = rng.integers(0, N, 7).astype(np.int64)
    cand = rng.integers(0, N, (7, 5)).astype(np.int64)
    te, ts, tc = (torch.from_numpy(a) for a in (embs, src, cand))
    pairs = [
        (scoring.score_all_tails(te, ts), jscoring.score_all_tails(embs, src)),
        (scoring.score_candidate_sets(te, ts, tc),
         jscoring.score_candidate_sets(embs, src, cand)),
        (scoring.score_pairs(te[ts], te[tc[:, 0]]),
         jscoring.score_pairs(embs[src], embs[cand[:, 0]])),
    ]
    for got, want in pairs:
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_wrapper_zero_shot_matches_jax_wrapper():
    # The demo's zero-shot step: a relation never seen before, wired in by
    # two new edges, through each package's HyperGNN(...)(feats, ei, texts).
    kg = ToyKnowledgeGraph()
    ei = np.concatenate([kg.edge_index, [[1, 2], [2, 0]]], axis=1)
    texts = kg.edge_texts + ["is colleague of"] * 2
    jax_model = JaxHyperGNN(text_dim=64, node_feat_dim=16, hidden_dim=32)
    jax_model.params = jax.tree_util.tree_map(
        jnp.asarray, _jax_params(jax_model.config, seed=3)
    )
    port = phg.HyperGNN(text_dim=64, node_feat_dim=16, hidden_dim=32, device="cpu")
    port.load_params(params_from_jax(_jax_params(jax_model.config, seed=3)))
    port.eval()
    got = port(kg.node_features, ei, texts)
    want = jax_model(kg.node_features, ei, texts)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        float(port.score_triple(got[1], got[2])),
        float(jax_model.score_triple(want[1], want[2])), rtol=0, atol=1e-4,
    )


def test_resolve_backend():
    ready = dict(rel_sorted=True, group_padded=True, has_sort_plan=True)
    bench = (1_000, 50, 10_000, 64)  # N, U, E, d_out of bench.py
    assert resolve_backend("auto", *bench, **ready) == "cuda"
    for b in ("pallas", "pallas_packed", "cuda"):
        assert resolve_backend(b, *bench, **ready) == "cuda"
    assert resolve_backend("gather", *bench, **ready) == "gather"
    # The other backends run as asked, and auto off the kernel layout picks
    # what the JAX package's _pick_backend picks at the same sizes.
    for b in ("dense", "grouped", "chunked"):
        want = jmp._pick_backend(b, *bench, rel_sorted=True)
        assert resolve_backend(b, *bench, **ready) == want == b
    no_plan = dict(ready, has_sort_plan=False)
    assert resolve_backend("auto", *bench, **no_plan) == (
        jmp._pick_backend("auto", *bench, rel_sorted=True)) == "grouped"
    unsorted = dict(rel_sorted=False, group_padded=False, has_sort_plan=False)
    assert resolve_backend("auto", *bench, **unsorted) == (
        jmp._pick_backend("auto", *bench)) == "dense"
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("ragged", *bench, **ready)


def test_cuda_backend_refuses_unaligned_host_rel_splits():
    feats, ei, etexts = _graph()
    g = encode_graph(ei, etexts, N, **_KERNEL_LAYOUT)
    plan = g.sort_plan.to("cpu")
    plan.rel_splits[1] += 2
    h = torch.zeros(N, 8)
    u_pad = g.char_ids.shape[0]
    with pytest.raises(ValueError, match="256"):
        relational_message_passing(
            h, *(torch.from_numpy(a) for a in g.arrays[:3]),
            torch.zeros(u_pad, 8, 8), torch.zeros(u_pad, 8, 8),
            torch.zeros(u_pad, 8), backend="cuda", rel_sorted=True,
            group_padded=True, sort_plan=plan,
        )


def test_hypergnn_refuses_a_missing_gpu_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        phg.HyperGNN(text_dim=16, node_feat_dim=8, hidden_dim=16)
    assert phg.HyperGNN(text_dim=16, node_feat_dim=8, hidden_dim=16,
                        device="cpu").device.type == "cpu"


def test_hypergnn_config_guards():
    with pytest.raises(ValueError):
        phg.HyperGNNConfig(text_dim=8, node_feat_dim=8, hidden_dim=8, num_layers=0)
    with pytest.raises(ValueError):
        phg.HyperGNNConfig(8, 8, 8, compute_dtype="float16")
