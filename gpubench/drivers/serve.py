"""Zero-shot serving: one client in a closed loop.

The resident graph and the node features are drawn from the seed; the
features live on the device. Each request adds a few edges under one
relation text the graph has never held to the resident graph and asks for
the top tails of a set of query heads: the port encodes the whole request
(``HyperGNN.preprocess``), runs the model (``forward_encoded``), scores
every node as the tail (``score_all_tails``), takes the top ones
(``topk``), and copies them to the host. The client sends the next request
when the answer is back. A request that raises is counted as failed.

Once the window has closed and the program is freed, the plain reference
answers a sample of the completed requests drawn from the seed, the
request with the most new edges among them, and each answer is compared.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from gpubench import compare, graphs, port, trace
from gpubench.reference import hypergnn as ref


def p95(latencies):
    """The nearest-rank 95th percentile."""
    ordered = sorted(latencies)
    return ordered[max(0, int(np.ceil(0.95 * len(ordered))) - 1)]


class Client:
    """The requests of one client, drawn from the seed: ``new_edges`` edges
    (uniform in its range) between uniform nodes under a relation text the
    graph has never held, and ``query_heads`` distinct heads."""

    def __init__(self, seed: int, edge_index, edge_texts, num_nodes: int, mix: dict):
        self.rng = np.random.default_rng([seed, 1])
        self.num_nodes, self.mix, self.resident = num_nodes, mix, edge_index.shape[1]
        # One buffer of edges and one list of texts hold every request: the
        # resident graph, then the request's new edges.
        self.edges = np.concatenate(
            [edge_index, np.zeros((2, mix["new_edges"][1]), edge_index.dtype)], axis=1)
        self.texts = list(edge_texts)

    def draw(self, tag: int) -> dict:
        lo, hi = self.mix["new_edges"]
        m = int(self.rng.integers(lo, hi + 1))
        return dict(new=self.rng.integers(0, self.num_nodes, size=(2, m)),
                    text=graphs.relation_text(self.rng, f"unseen relation {tag}"),
                    heads=self.rng.choice(self.num_nodes, size=self.mix["query_heads"],
                                          replace=False))

    def payload(self, req: dict):
        """The request as the server gets it: the whole graph's raw edges and
        texts. It overwrites the previous request's payload."""
        e, m = self.resident, req["new"].shape[1]
        self.edges[:, e:e + m] = req["new"]
        self.texts[e:] = [req["text"]] * m
        return self.edges[:, :e + m], self.texts

    def warm(self, serve) -> None:
        for i in range(self.mix["warm_requests"]):
            req = self.draw(-1 - i)
            serve(*self.payload(req), req["heads"])


def reference_answer(reference, weights, feats, client, req):
    """The reference's ``[H, N]`` scores of every tail for ``req``'s heads."""
    graph = ref.Graph(*client.payload(req), client.num_nodes, feats.device)
    z = reference.forward(weights, feats, graph)[-1]
    return reference.scores(z, torch.as_tensor(req["heads"], device=feats.device))


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> SimpleNamespace:
    model, mix = cell.config["model"], cell.mix
    if model["precision"] != "highest" or model["compute_dtype"] != "float32":
        raise ValueError("HyperGNN serves at precision='highest' in float32 only")
    spans = trace.Spans(t_start)
    feats_np, ei, etexts = graphs.draw(cell.config["graph"], seed, model["node_feat_dim"])
    num_nodes = feats_np.shape[0]
    spans.mark("graph drawn")
    weights = ref.draw_params(model, seed, device)
    server = port.HyperGNN(model["text_dim"], model["node_feat_dim"], model["hidden_dim"],
                           model["num_layers"], model["dropout"], model["char_emb_dim"],
                           backend="cuda", device=device).eval()
    server.load_params(port.nest(weights))
    feats = torch.as_tensor(feats_np, device=device)
    spans.mark("model built, features on the device")
    client = Client(seed, ei, etexts, num_nodes, mix)
    top_k = mix["top_k"]

    def serve(edge_index, edge_texts, heads):
        with spans("preprocess"):
            graph = server.preprocess(edge_index, edge_texts, num_nodes)
        with spans("device"):
            with spans("forward_encoded"):
                embs = server.forward_encoded(feats, graph)
            with torch.inference_mode(), spans("score_topk"):
                heads = torch.as_tensor(heads, device=device)
                scores, tails = torch.topk(port.scoring.score_all_tails(embs, heads), top_k, dim=1)
            with spans("to_host"):
                return scores.cpu(), tails.cpu()

    client.warm(serve)
    spans.mark("warm requests")
    spans.seconds.clear()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    done, latencies, failed = [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        req = client.draw(len(done) + failed)
        edge_index, edge_texts = client.payload(req)
        t = time.perf_counter()
        try:
            answer = serve(edge_index, edge_texts, req["heads"])
        except RuntimeError:
            failed += 1
            continue
        latencies.append(time.perf_counter() - t)
        done.append((req, answer))
    window_s = time.perf_counter() - t0
    span_ms = spans.means_ms()
    if latencies:
        q = np.quantile(np.asarray(latencies) * 1e3, [0.5, 0.9, 0.95, 0.99, 1.0])
        print("latency ms: p50 {:.2f} p90 {:.2f} p95 {:.2f} p99 {:.2f} max {:.2f}".format(*q),
              file=sys.stderr)

    profiled = None
    if traced:
        n = mix["profiled_requests"]
        reqs = [client.draw(-100 - i) for i in range(n)]
        profiled = trace.profile(lambda: [serve(*client.payload(r), r["heads"]) for r in reqs],
                                 n, spans)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del server, feats
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if not done:
        raise RuntimeError("no request completed in the window")
    pick = np.random.default_rng([seed, 2])
    longest = max(range(len(done)), key=lambda j: done[j][0]["new"].shape[1])
    rest = [j for j in range(len(done)) if j != longest]
    sample = [longest] + sorted(pick.choice(rest, size=min(len(rest), mix["checked_requests"] - 1),
                                            replace=False).tolist())
    reference = ref.Reference(model)
    feats_ref = torch.as_tensor(feats_np, device=device)
    readings = []
    with torch.no_grad():
        for j in sample:
            req, (scores, tails) = done[j]
            want = reference_answer(reference, weights, feats_ref, client, req)
            readings.append(compare.serve_numbers(scores, tails, want))
    correct, checks = compare.held(compare.worst(readings), cell.limits)
    correct = correct and failed == 0
    return SimpleNamespace(
        correct=correct, checks=checks, attempted=len(done) + failed, failed=failed,
        setup_s=setup_s, memory_peak_bytes=peak, trace=profiled,
        e2e={"serve_p95_ms": 1e3 * p95(latencies)},
        layer=dict(span_ms=span_ms, requests=len(done), seconds=window_s))
