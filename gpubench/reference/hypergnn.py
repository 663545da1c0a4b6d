"""The plain HyperGNN: float32 PyTorch written from the model's equations.

It imports nothing of the program under test and takes nothing the program
made: it tokenizes, deduplicates and lays out the raw edges itself, and
runs every product as one ``mm`` whose inputs are float32, or, for the
control, rounded to TF32 first (10 mantissa bits, the precision below the
one the configurations state).

The model, for node features ``x [N, F]``, edges ``(u → v)`` with relation
texts, and ``d`` the hidden width::

    h0      = relu(x W_in + b_in)
    t_r     = tanh(mean_{chars c of text r} E[min(ord c, 127)] P + p)   ("" = one code 0)
    per layer l, from t_r by three MLPs (Linear → ReLU, twice, then Linear,
    times exp(log_scale)): W_msg[r], W_self[r] [d, d] and bias[r] [d]
    m_e     = h_u W_msg[r_e] + bias[r_e] + h_v W_self[r_e]
    h'_v    = LayerNorm(relu(sum_{e → v} m_e / max(cnt_v, 1) + h_v))
    score   = <z_head, z_tail>
    loss    = mean over real edges of max(0, margin - score(u, v) + score(u, v_neg))

Negatives are handed in. In the ``roll`` mode they are the positive tails of
the kernels' edge layout rotated by one shift per step: relation-sorted in
first-occurrence order of the texts, each relation's group padded with
masked ``(0 → 0)`` rows to a multiple of 256. :func:`layout` works that
layout out again from the raw edges.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

GROUP_PAD = 256
CHAR_VOCAB = 128
LN_EPS = 1e-5
GEN_INIT_SCALE = 0.01
GEN_HEAD_STD = 0.01
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
HEADS = ("W_msg", "W_self", "bias")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_specs(model: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """``(path, shape, init, value)`` of every parameter leaf. ``init`` is
    "uniform" (U(-value, value), value = 1/sqrt(fan_in)), "normal" (N(0,
    value²)) or "const" (every entry = value). Linear weights are stored
    ``[d_in, d_out]`` and applied as ``x @ w + b``."""
    t, c, f, d = model["text_dim"], model["char_emb_dim"], model["node_feat_dim"], model["hidden_dim"]
    g = max(64, 2 * t)
    specs = [("text_encoder.char_emb", (CHAR_VOCAB, c), "normal", 1.0)]

    def linear(path, d_in, d_out):
        k = 1.0 / math.sqrt(d_in)
        specs.extend([(f"{path}.w", (d_in, d_out), "uniform", k),
                      (f"{path}.b", (d_out,), "uniform", k)])

    linear("text_encoder.proj", c, t)
    linear("input_proj", f, d)
    outs = {"W_msg": d * d, "W_self": d * d, "bias": d}
    for layer in range(model["num_layers"]):
        for head in HEADS:
            base = f"weight_generators.{layer}.heads.{head}"
            linear(f"{base}.0", t, g)
            linear(f"{base}.1", g, g)
            specs.extend([(f"{base}.2.w", (g, outs[head]), "normal", GEN_HEAD_STD),
                          (f"{base}.2.b", (outs[head],), "const", 0.0)])
        for head in HEADS:
            specs.append((f"weight_generators.{layer}.log_scales.{head}", (1,), "const",
                          math.log(GEN_INIT_SCALE)))
    for layer in range(model["num_layers"]):
        specs.extend([(f"layer_norms.{layer}.g", (d,), "const", 1.0),
                      (f"layer_norms.{layer}.b", (d,), "const", 0.0)])
    return specs


def draw_params(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf drawn from ``seed`` on ``device`` in two large calls (one
    uniform, one normal draw over all leaves of that kind), then sliced."""
    specs = param_specs(model)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in specs if k == kind)
             for kind in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2 - 1,
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    used = dict.fromkeys(pools, 0)
    out = {}
    for path, shape, kind, value in specs:
        n = math.prod(shape)
        if kind == "const":
            out[path] = torch.full(shape, value, device=device)
            continue
        start = used[kind]
        used[kind] += n
        out[path] = (pools[kind][start:start + n] * value).reshape(shape)
    return out


# ---------------------------------------------------------------------------
# Encode and layout, worked out again from the raw edges
# ---------------------------------------------------------------------------


def dedup(edge_texts: Sequence[str]) -> Tuple[List[str], np.ndarray]:
    """Unique texts in first-occurrence order, and each edge's index."""
    index: Dict[str, int] = {}
    rel = np.fromiter((index.setdefault(t, len(index)) for t in edge_texts),
                      dtype=np.int64, count=len(edge_texts))
    return list(index), rel


def tokenize(texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """``[U, L]`` codes ``min(ord(c), 127)`` (the empty text is one code 0)
    and ``[U]`` lengths."""
    codes = [[min(ord(ch), CHAR_VOCAB - 1) for ch in t] or [0] for t in texts]
    lengths = np.asarray([len(c) for c in codes], dtype=np.int64)
    ids = np.zeros((len(codes), int(lengths.max())), dtype=np.int64)
    for i, c in enumerate(codes):
        ids[i, :len(c)] = c
    return ids, lengths


def layout(rel: np.ndarray, num_rel: int) -> Tuple[np.ndarray, int]:
    """Row of each raw edge in the relation-sorted layout whose relation
    groups are padded to multiples of ``GROUP_PAD``, and its row count."""
    counts = np.bincount(rel, minlength=num_rel)
    padded = -(-counts // GROUP_PAD) * GROUP_PAD
    start = np.concatenate([[0], np.cumsum(padded)[:-1]])
    order = np.argsort(rel, kind="stable")
    within = np.empty(rel.shape[0], dtype=np.int64)
    within[order] = np.arange(rel.shape[0]) - np.concatenate([[0], np.cumsum(counts)[:-1]])[rel[order]]
    return start[rel] + within, int(padded.sum())


class Graph:
    """One raw graph on ``device``: edges sorted by relation (for the
    per-relation products), in-degrees, tokenized texts, and the row of
    each edge in the kernels' layout."""

    def __init__(self, edge_index: np.ndarray, edge_texts: Sequence[str], num_nodes: int,
                 device):
        texts, rel = dedup(edge_texts)
        ids, lengths = tokenize(texts)
        order = np.argsort(rel, kind="stable")
        self.num_nodes, self.num_edges = num_nodes, rel.shape[0]
        self.rows, self.layout_rows = layout(rel, len(texts))
        self.bounds = np.concatenate([[0], np.cumsum(np.bincount(rel, minlength=len(texts)))])
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
        self.src, self.dst = as_t(edge_index[0]), as_t(edge_index[1])
        self.src_sorted, self.dst_sorted = as_t(edge_index[0][order]), as_t(edge_index[1][order])
        self.char_ids, self.lengths = as_t(ids), as_t(lengths)
        self.count = torch.bincount(self.dst, minlength=num_nodes).clamp(min=1).float()[:, None]
        self.device = device

    def layout_tails(self) -> torch.Tensor:
        """The tail of every layout row (0 on padded rows)."""
        tails = torch.zeros(self.layout_rows, dtype=torch.long, device=self.device)
        tails[torch.as_tensor(self.rows, device=self.device)] = self.dst.long()
        return tails


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` as the tensor cores take it in TF32: every product of the
    forward and of the backward with its inputs rounded to TF32."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ b.T, a.T @ g


class Reference:
    """The model's equations at one precision: "f32" (products in full
    float32, TF32 off) or "tf32" (each product's inputs rounded to TF32)."""

    def __init__(self, model: dict, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.model, self.precision = model, precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32":
            return _TF32Product.apply(a, b)
        return a @ b

    def linear(self, p, path, x):
        return self.mm(x, p[f"{path}.w"]) + p[f"{path}.b"]

    def text(self, p, graph: Graph) -> torch.Tensor:
        emb = p["text_encoder.char_emb"][graph.char_ids]
        mask = torch.arange(graph.char_ids.shape[1], device=emb.device) < graph.lengths[:, None]
        pooled = (emb * mask[..., None]).sum(1) / graph.lengths[:, None].float()
        return torch.tanh(self.linear(p, "text_encoder.proj", pooled))

    def banks(self, p, layer: int, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        d = self.model["hidden_dim"]
        shapes = {"W_msg": (d, d), "W_self": (d, d), "bias": (d,)}
        out = {}
        for head in HEADS:
            base = f"weight_generators.{layer}.heads.{head}"
            x = torch.relu(self.linear(p, f"{base}.0", t))
            x = torch.relu(self.linear(p, f"{base}.1", x))
            flat = self.linear(p, f"{base}.2", x)
            scale = torch.exp(p[f"weight_generators.{layer}.log_scales.{head}"])
            out[head] = flat.reshape((t.shape[0],) + shapes[head]) * scale
        return out

    def layer(self, p, layer: int, h: torch.Tensor, banks, graph: Graph) -> torch.Tensor:
        parts = []
        for r in range(len(graph.bounds) - 1):
            lo, hi = int(graph.bounds[r]), int(graph.bounds[r + 1])
            if lo == hi:
                continue
            x = torch.cat([h[graph.src_sorted[lo:hi]], h[graph.dst_sorted[lo:hi]]], dim=1)
            w = torch.cat([banks["W_msg"][r], banks["W_self"][r]], dim=0)
            parts.append(self.mm(x, w) + banks["bias"][r])
        agg = torch.zeros_like(h).index_add_(0, graph.dst_sorted, torch.cat(parts))
        z = torch.relu(agg / graph.count + h)
        mean = z.mean(-1, keepdim=True)
        var = (z - mean).square().mean(-1, keepdim=True)
        return ((z - mean) / torch.sqrt(var + LN_EPS) * p[f"layer_norms.{layer}.g"]
                + p[f"layer_norms.{layer}.b"])

    def forward(self, p, feats: torch.Tensor, graph: Graph) -> List[torch.Tensor]:
        """Each layer's node embeddings ``[N, d]``."""
        h = torch.relu(self.linear(p, "input_proj", feats))
        t = self.text(p, graph)
        out = []
        for layer in range(self.model["num_layers"]):
            h = self.layer(p, layer, h, self.banks(p, layer, t), graph)
            out.append(h)
        return out

    def scores(self, z: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
        """``[len(heads), N]`` scores of every node as the tail."""
        return self.mm(z[heads], z.T)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


# Hinges this close to 0 may enter the loss on one side of rounding and not
# on the other. A hinge of exactly 0 is one of them: the clamp below passes
# its gradient, as it does above 0.
KINK_BAND = 2e-6


def hinges(z: torch.Tensor, src, dst, neg, margin: float) -> torch.Tensor:
    """``margin - <z_u, z_v> + <z_u, z_neg>`` of each positive."""
    return margin - (z[src] * z[dst]).sum(-1) + (z[src] * z[neg]).sum(-1)


def train_steps(ref: Reference, params: Dict[str, torch.Tensor], feats: torch.Tensor,
                graph: Graph, negatives: Sequence, *, neg_mode: str, margin: float,
                lr: float, keep: float = 1.0, flip: frozenset = frozenset()) -> dict:
    """One Adam step per entry of ``negatives`` from ``params`` (left as
    they are): each step's loss, the first step's gradient, and every
    leaf's change after the last step. A roll step's negative is its
    shift (the tail of layout row ``(i + k) % rows`` is row i's); a uniform
    step's the ``[E]`` tails of the raw edges. ``keep`` < 1 scores only
    that leading share of the edges (a fault for the control). Beside
    them, ``near_kink``: each step's positives whose hinge lies within
    ``KINK_BAND`` of 0, where rounding decides whether they enter the loss.
    ``flip`` names ``(step, positive)`` pairs whose decision is taken the
    other way: a hinge the loss would count is left out, one it would leave
    out is counted."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    scored = max(1, int(graph.num_edges * keep))
    src, dst = graph.src[:scored].long(), graph.dst[:scored].long()
    rows = torch.as_tensor(graph.rows[:scored], device=graph.device)
    tails = graph.layout_tails() if neg_mode == "roll" else None
    losses, first_grad, near_kink = [], None, []
    for step, neg in enumerate(negatives, start=1):
        if neg_mode == "roll":
            neg = tails[(rows + int(neg)) % graph.layout_rows]
        else:
            neg = torch.as_tensor(neg, device=graph.device)[:scored].long()
        z = ref.forward(p, feats, graph)[-1]
        hinge = hinges(z, src, dst, neg, margin)
        near_kink.append((hinge.detach().abs() < KINK_BAND).nonzero().flatten().tolist())
        terms = hinge.clamp(min=0.0)
        flipped = [i for s, i in flip if s == step]
        if flipped:
            picked = torch.as_tensor(flipped, device=hinge.device)
            h = hinge[picked]
            terms = terms.index_put((picked,), torch.where(h >= 0, torch.zeros_like(h), h))
        loss = terms.mean()
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        grads = [torch.zeros_like(w) if g is None else g for w, g in zip(p.values(), grads)]
        if first_grad is None:
            first_grad = dict(zip(p, grads))
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                m[k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                v2[k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                mhat = m[k] / (1 - ADAM_B1 ** step)
                vhat = v2[k] / (1 - ADAM_B2 ** step)
                w.sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
    change = {k: (p[k].detach() - params[k]) for k in p}
    return dict(losses=losses, first_grad=first_grad, change=change, near_kink=near_kink)
