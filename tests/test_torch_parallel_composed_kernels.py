"""The composed step's other contribution backends and its sort-free
aggregation on k gloo ranks against the JAX package's on k virtual CPU
devices (tests/test_composed.py's grouped, agg_sorted and kernel cases):

- ``contrib="grouped"`` over each shard's relation-sorted edges;
- ``agg_sorted=True`` (the in-shard sum through the host plan) in halo mode;
- ``contrib="pallas_packed"``, ``"pallas"`` and ``"cuda"``: the port's
  ``cuda`` backend over each shard's SortPlan (here the kernels' plain
  versions), and ``grouped``, on the group-padded layout at d=64, each
  against JAX's ``grouped`` step on the same inputs (JAX holds its kernel
  backends to that step, test_composed.py:620-676).

The loss within 1e-5 and the step's gradients and parameters as
``torch_composed_cases.assert_adam_step_close`` holds them. One spawn of k
ranks per world size (``torch_parallel_ranks_cd.composed_kernels``).
"""

import functools

import pytest

import numpy as np

from torch_composed_cases import assert_adam_step_close, jax_step, rank_inputs, raw_case
from torch_parallel_ranks import spawn

WORLDS = (2, 4)
# Name: (case, n, JAX step options) of test_composed.py's cases.
CASES = {
    "grouped": (lambda: raw_case(12), 26,
                dict(rng_seed=41, halo=True, contrib="grouped", rel_sort_local=True)),
    "agg": (lambda: raw_case(13), 26, dict(rng_seed=41, halo=True, agg_sorted=True)),
    "kernel": (lambda: raw_case(21, n=40, e=400, u=5, hidden=64), 40,
               dict(rng_seed=7, halo=True, contrib="grouped", rel_sort_local=True,
                    group_pad=256, agg_sorted=True)),
}
KERNEL_CONTRIBS = ("pallas_packed", "pallas", "cuda", "grouped")


@functools.lru_cache(maxsize=None)
def _jax(k):
    return {name: jax_step(case(), n, k, **kw) for name, (case, n, kw) in CASES.items()}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda k: f"k{k}")
def ranks(request, tmp_path_factory):
    k = request.param
    want = _jax(k)
    inputs = {}
    for name, (case, n, _) in CASES.items():
        extra = dict(want[name][2], agg_sorted=np.int64(name == "agg"))
        inputs.update({f"{name}/{key}": v for key, v in rank_inputs(case(), n, **extra).items()})
    outs = spawn("torch_parallel_ranks_cd:composed_kernels", k,
                 tmp_path_factory.mktemp(f"composed_kernels_k{k}"), inputs)
    return want, outs


@pytest.mark.parametrize("name", ["grouped", "agg"])
def test_composed_step_matches_jax(ranks, name):
    want, outs = ranks
    loss, params, _, grads = want[name]
    for o in outs:
        np.testing.assert_allclose(float(o[f"{name}/loss"][0]), loss, atol=1e-5)
        assert_adam_step_close(o, name, params, grads)


@pytest.mark.parametrize("contrib", KERNEL_CONTRIBS)
def test_kernel_contribs_match_jax_grouped(ranks, contrib):
    want, outs = ranks
    loss, params, _, grads = want["kernel"]
    for o in outs:
        np.testing.assert_allclose(float(o[f"kernel/{contrib}/loss"][0]), loss, atol=1e-5)
        assert_adam_step_close(o, f"kernel/{contrib}", params, grads)
