"""The port's experiment scripts (``graph_hypernetwork_forge_tpu_torch/
experiments/``) and their optimizer pieces against the JAX package's
``experiments/*.py`` and optax.

- ``training.adam`` / ``adamw`` under a constant rate and under
  ``warmup_cosine_decay_schedule`` equal ``optax.adam`` / ``optax.adamw`` /
  ``optax.warmup_cosine_decay_schedule`` over 5 updates of the same
  gradients within 1e-6, the first update (at ``schedule(0)``) included; a
  scheduled optimizer restored from its state dict goes on at its count.
- The evaluation protocol: the port's ``sweep_zeroshot.run_one`` and the
  JAX script's own ``run_one``, each with its model replaced by a table of
  the same embeddings (one per step and graph), give the same row: the
  whole test split, the zero-shot subset, each held-out relation, the
  valid curve and the best-on-valid ``sel_*`` metrics.
- Each script's ``main`` on the CPU prints the JAX script's lines and JSON
  keys (``train_linkpred`` on ``--dataset tiny``; ``sweep_zeroshot`` and
  ``parity_zeroshot``, which take no ``--dataset tiny``, on wn18rr-zeroshot
  at scale 0.02), 3 steps each; ``parity_zeroshot --against`` joins the
  JAX script's rows file into the ``side_by_side`` row. The JAX scripts'
  ``main`` runs with its model replaced by a stub (``_stub_jax_model``):
  the lines and keys come from the script's own code, and the stub spares
  the lane the JAX compiles of a training run.
"""

import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graph_hypernetwork_forge_tpu.data.datasets import (
    wn18rr_zero_shot_like as jax_wn18rr,
)
from graph_hypernetwork_forge_tpu.models import hypergnn as jax_hypergnn
from graph_hypernetwork_forge_tpu.models.hypergnn import HyperGNNConfig as JaxConfig
from graph_hypernetwork_forge_tpu_torch.data.datasets import wn18rr_zero_shot_like
from graph_hypernetwork_forge_tpu_torch.experiments import (
    parity_zeroshot,
    protocol,
    sweep_zeroshot,
    train_linkpred,
)
from graph_hypernetwork_forge_tpu_torch.models.hypergnn import HyperGNNConfig
from graph_hypernetwork_forge_tpu_torch.training.train import (
    adam,
    adamw,
    warmup_cosine_decay_schedule,
)

# The module (the package's ``train`` attribute is the function).
jax_train = importlib.import_module("graph_hypernetwork_forge_tpu.training.train")
REPO = Path(__file__).resolve().parents[1]
SMALL = ["--scale", "0.02", "--steps", "3", "--seeds", "0"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The scripts run small graphs: one intra-op thread, so the test does
    not oversubscribe the cores it shares with other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name):
    """The JAX package's ``experiments/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_experiments_{name}",
                                                  REPO / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# Optimizer pieces
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adam_cosine": (lambda lr: adam(lr), lambda lr: optax.adam(lr), "cosine"),
    "adamw_constant": (lambda lr: adamw(lr, weight_decay=0.1),
                       lambda lr: optax.adamw(lr, weight_decay=0.1), "constant"),
    "adamw_cosine": (lambda lr: adamw(lr, weight_decay=0.1),
                     lambda lr: optax.adamw(lr, weight_decay=0.1), "cosine"),
    "adamw_default_decay": (lambda lr: adamw(lr), lambda lr: optax.adamw(lr), "cosine"),
}


def _rates(kind, peak=1e-2, warmup=2, decay=6):
    if kind == "constant":
        return peak, peak
    return (warmup_cosine_decay_schedule(0.0, peak, warmup, decay),
            optax.warmup_cosine_decay_schedule(0.0, peak, warmup, decay))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax_over_five_updates(name):
    port_make, jax_make, kind = OPTIMIZERS[name]
    port_lr, jax_lr = _rates(kind)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(5)]
    opt = jax_make(jax_lr)
    jp = jnp.asarray(p0)
    state = opt.init(jp)
    leaf = torch.tensor(p0, requires_grad=True)
    port = port_make(port_lr)([leaf])
    for i, g in enumerate(grads):
        updates, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        leaf.grad = torch.from_numpy(g.copy())
        port.step()
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6,
                                   err_msg=f"update {i}")
    if kind == "cosine":
        # Warmup from 0: the first update moved nothing but the decay.
        assert port_lr(0) == 0.0


def test_schedule_values_match_optax():
    for args in ((0.0, 1e-2, 2, 6), (1e-4, 3e-3, 10, 100, 1e-5), (0.0, 1e-3, 1, 2)):
        port, want = warmup_cosine_decay_schedule(*args), optax.warmup_cosine_decay_schedule(*args)
        # optax computes in f32: within a few f32 ulps of the peak.
        for count in range(0, args[3] + 5):
            np.testing.assert_allclose(port(count), float(want(count)), rtol=0,
                                       atol=1e-6 * args[1])
    with pytest.raises(ValueError, match="must exceed warmup_steps"):
        warmup_cosine_decay_schedule(0.0, 1.0, 5, 5)


def test_scheduled_optimizer_resumes_at_its_count():
    sched = warmup_cosine_decay_schedule(0.0, 1e-2, 2, 8)
    rng = np.random.default_rng(1)
    grads = [torch.from_numpy(rng.standard_normal(4).astype(np.float32)) for _ in range(6)]
    whole = torch.zeros(4, requires_grad=True)
    opt = adamw(sched, weight_decay=0.1)([whole])
    for g in grads:
        whole.grad = g.clone()
        opt.step()
    part = torch.zeros(4, requires_grad=True)
    first = adamw(sched, weight_decay=0.1)([part])
    for g in grads[:3]:
        part.grad = g.clone()
        first.step()
    saved = first.state_dict()
    resumed_leaf = part.detach().clone().requires_grad_(True)
    resumed = adamw(sched, weight_decay=0.1)([resumed_leaf])
    resumed.load_state_dict(saved)
    assert resumed.param_groups[0]["lr"] == sched(3)
    for g in grads[3:]:
        resumed_leaf.grad = g.clone()
        resumed.step()
    assert torch.equal(resumed_leaf, whole)


# ---------------------------------------------------------------------------
# The evaluation protocol against the JAX script's run_one
# ---------------------------------------------------------------------------

STEPS = 4


def _table(kg, hidden=16, seed=3):
    """Embeddings per (step count, real edges of the graph): the train
    graph's and the full graph's after each step."""
    rng = np.random.default_rng(seed)
    train_edges = kg.split_edges("train")[0].shape[1]
    return {(c, e): rng.standard_normal((kg.num_nodes, hidden)).astype(np.float32)
            for c in range(STEPS + 1) for e in (train_edges, kg.num_edges)}


def test_run_one_protocol_matches_jax_run_one(monkeypatch):
    jsw = _jax_script("sweep_zeroshot")
    kg, jkg = wn18rr_zero_shot_like(seed=0, scale=0.02), jax_wn18rr(seed=0, scale=0.02)
    table = _table(kg)

    def jax_step(params, opt_state, feats, *arrays):
        return params + 1.0, opt_state, jnp.float32(0.25)

    monkeypatch.setattr(jsw, "init_hypergnn", lambda config, key: jnp.zeros(()))
    monkeypatch.setattr(jsw, "make_train_step", lambda config, optimizer, **kw: jax_step)
    monkeypatch.setattr(jsw, "apply_hypergnn", lambda config, params, feats, *arrays: (
        jnp.asarray(table[(int(params), int(np.asarray(arrays[3]).sum()))])))

    def port_step(params, opt_state, feats, *arrays):
        with torch.no_grad():
            params["c"] += 1.0
        return params, opt_state, torch.tensor(0.25)

    monkeypatch.setattr(sweep_zeroshot, "init_hypergnn", lambda config, gen: {
        "c": torch.zeros(())})
    monkeypatch.setattr(sweep_zeroshot, "make_train_step", lambda config, **kw: port_step)
    monkeypatch.setattr(protocol, "apply_hypergnn", lambda config, params, feats, *arrays: (
        torch.from_numpy(table[(int(params["c"]), int(arrays[3].sum()))])))

    dims = dict(text_dim=16, node_feat_dim=kg.node_features.shape[1], hidden_dim=16,
                rel_sorted=True)
    kw = dict(lr_schedule="cosine", weight_decay=0.01, eval_every=1)
    want = jsw.run_one(jkg, JaxConfig(**dims), 2, STEPS, 1e-3, 0, **kw)
    got = sweep_zeroshot.run_one(kg, HyperGNNConfig(**dims), 2, STEPS, 1e-3, 0,
                                 device="cpu", **kw)
    for row in (got, want):
        row.pop("train_s")
    assert len(want["zero_shot_per_relation"]) == len(kg.zero_shot_relations) > 1
    assert len({v["valid_mrr"] for v in want["valid_curve"]}) > 1
    assert "sel_zero_shot_mrr" in want
    assert json.dumps(got) == json.dumps(want)


def test_evaluate_split_takes_tensors_or_arrays():
    kg = wn18rr_zero_shot_like(seed=1, scale=0.02)
    embs = np.random.default_rng(0).standard_normal((kg.num_nodes, 8)).astype(np.float32)
    test_ei, test_texts = kg.split_edges("test")
    a = protocol.evaluate_split(embs, kg, test_ei, test_texts, per_relation=True,
                                device="cpu")
    b = protocol.evaluate_split(torch.from_numpy(embs), kg, test_ei, test_texts,
                                per_relation=True)
    assert a == b and "zero_shot_per_relation" in a


# ---------------------------------------------------------------------------
# The scripts' mains
# ---------------------------------------------------------------------------


def _stub_jax_model(monkeypatch, *modules):
    """The JAX model replaced where each module looks it up: parameters a
    step counter, a step that counts, embeddings ``[N, 16]`` drawn from the
    graph's edge count and the counter."""
    def init(config, key):
        return jnp.zeros(())

    def make_step(config, optimizer, **kw):
        return lambda params, opt_state, feats, *arrays: (params + 1.0, opt_state,
                                                          jnp.float32(0.25))

    def apply(config, params, feats, *arrays):
        rng = np.random.default_rng(int(np.asarray(arrays[3]).sum()) + int(params))
        return jnp.asarray(rng.standard_normal((feats.shape[0], 16)).astype(np.float32))

    for module in modules:
        for name, fn in (("init_hypergnn", init), ("make_train_step", make_step),
                         ("apply_hypergnn", apply)):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, fn)


def _line_shapes(text):
    """Each printed line reduced to what the JAX script fixes: a JSON
    line's keys, a step or eval line's kind and keys, another line's words
    up to its first number."""
    shapes = []
    for line in text.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            shapes.append(("json", tuple(row), row.get("framework")))
        elif line.startswith(("[step", "  eval@")):
            head = line.split()[0] if line.startswith("[") else line.split(":")[0]
            shapes.append(("kv", re.sub(r"\d+", "#", head.strip()),
                           tuple(re.findall(r"(\S+)=", line))))
        else:
            shapes.append(("text", re.split(r"\d", line)[0]))
    return shapes


def test_train_linkpred_main_prints_jax_lines(capsys, monkeypatch, tmp_path):
    argv = ["--dataset", "tiny", "--steps", "3", "--eval-every", "2",
            "--num-negatives", "2", "--lr-schedule", "cosine"]
    jtl = _jax_script("train_linkpred")
    _stub_jax_model(monkeypatch, jtl)
    assert jtl.main(argv) == 0
    want = capsys.readouterr().out
    assert train_linkpred.main(argv + ["--device", "cpu", "--checkpoint-dir",
                                       str(tmp_path / "ckpt")]) == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want.splitlines()[0]  # the dataset line
    assert got[-1] == f"checkpoint saved: {tmp_path / 'ckpt' / 'step_3'}"
    assert _line_shapes("\n".join(got[:-1])) == _line_shapes(want)
    assert any(line.startswith("  eval@3: mrr=") and "zero_shot_mrr=" in line
               for line in got)


def test_sweep_zeroshot_main_prints_jax_keys(capsys, monkeypatch, tmp_path):
    args = SMALL + ["--negatives", "2", "--eval-every", "2", "--weight-decay", "0.01"]
    monkeypatch.setattr(sys, "argv", ["sweep_zeroshot.py"] + args)
    jsw = _jax_script("sweep_zeroshot")
    _stub_jax_model(monkeypatch, jsw)
    jsw.main()
    want = capsys.readouterr().out
    out = tmp_path / "rows.jsonl"
    assert sweep_zeroshot.main(args + ["--device", "cpu", "--out", str(out)]) == 0
    got = capsys.readouterr().out
    assert _line_shapes(got) == _line_shapes(want)
    assert out.read_text().splitlines() == got.splitlines()
    rows = [json.loads(line) for line in got.splitlines()]
    assert "sel_zero_shot_mrr" in rows[0] and rows[1]["aggregate"] is True


def test_parity_zeroshot_joins_a_jax_rows_file(capsys, monkeypatch, tmp_path):
    jax_rows = tmp_path / "jax.jsonl"
    monkeypatch.setattr(sys, "argv", ["parity_zeroshot.py", "--frameworks", "jax",
                                      "--out", str(jax_rows)] + SMALL)
    _stub_jax_model(monkeypatch, jax_hypergnn, jax_train)  # run_jax imports them late
    _jax_script("parity_zeroshot").main()
    assert jax.default_backend() == "cpu"
    want = [json.loads(line) for line in jax_rows.read_text().splitlines()]
    capsys.readouterr()
    port_rows = tmp_path / "port.jsonl"
    assert parity_zeroshot.main(SMALL + ["--device", "cpu", "--against", str(jax_rows),
                                         "--out", str(port_rows)]) == 0
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [json.loads(line) for line in port_rows.read_text().splitlines()] == got
    assert [tuple(r) for r in got[:2]] == [tuple(r) for r in want]
    assert got[0]["framework"] == got[1]["framework"] == "torch_port"
    side = got[2]
    assert side["side_by_side"] is True
    for key in ("zero_shot_mrr", "mrr", "hits@10"):
        assert side[f"jax_{key}"] == want[1][f"{key}_mean"]
        assert side[f"port_{key}"] == got[1][f"{key}_mean"]
    with pytest.raises(ValueError, match="steps"):
        parity_zeroshot.side_by_side(dict(got[1], steps=4), str(jax_rows))
    with pytest.raises(SystemExit):
        parity_zeroshot.main(SMALL + ["--frameworks", "torch,jax", "--device", "cpu"])
