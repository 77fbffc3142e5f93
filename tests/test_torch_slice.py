"""The port's serving slice against the JAX package's, on the CPU.

The same ``synthesize`` trace (three colocated reduced qwen2-7b, the CI
gates' skewed power-law mix) is served by both packages under the
deterministic ``TickCostModel`` clock, with the JAX package's weights
carried across by ``params_to_torch``:

* every request's greedy tokens are equal;
* ``ServeReport.to_json()`` is equal apart from ``wall_s``;
* the final pool contents agree within 2e-5 (float32; the two
  frameworks sum in different orders).

Cases: the CI gates' loop (chunked prefill, fused ADBS), the CLI's
default whole-prompt prefill, and the serial round-robin tick.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.workload import synthesize as jsynthesize
from repro.models.transformer import init_params as jinit
from repro.serving import driver as JD
from repro_torch.core.workload import synthesize as tsynthesize
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import driver as TD

torch.set_num_threads(2)

NAMES = ["llm0", "llm1", "llm2"]
TRACE = dict(alpha=2.1, max_rate=12.0, horizon=1.0, seed=0, mean_prompt=24,
             mean_output=8, max_len=128)


@pytest.mark.parametrize("chunk,fused,policy", [(16, True, "adbs"),
                                                (0, True, "adbs"),
                                                (16, False, "round_robin")])
def test_slice_matches_reference(chunk, fused, policy):
    wl_j = jsynthesize(NAMES, **TRACE)
    wl_t = tsynthesize(NAMES, **TRACE)
    specs = [(n, "qwen2-7b", wl_j.rates[n]) for n in NAMES]
    common = dict(pool_blocks=4000, max_slots=4, chunk_tokens=chunk,
                  policy=policy, fused=fused)
    uj = JD.build_unit_from_specs(specs, **common)
    rj = JD.serve_workload([uj], wl_j, seed=0, cost=JD.TickCostModel())

    cfg = jconfigs.get_reduced("qwen2-7b")
    trees = [params_to_torch(jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.PRNGKey(i), cfg, jnp.float32)), "cpu")
        for i in range(len(NAMES))]
    ut = TD.build_unit_from_specs(specs, dtype=torch.float32, device="cpu",
                                  params=trees, **common)
    rt = TD.serve_workload([ut], wl_t, seed=0, cost=TD.TickCostModel())

    assert len(ut.fused_groups) == len(uj.fused_groups)
    tok_j = {r.req_id: r.output for r in uj.stats.finished}
    tok_t = {r.req_id: r.output for r in ut.stats.finished}
    assert len(tok_j) == len(wl_j.requests) > 5
    assert tok_t == tok_j
    a, b = rj.to_json(), rt.to_json()
    a.pop("wall_s")
    b.pop("wall_s")
    assert b == a
    assert ut.pool.n_head_blocks == uj.pool.n_head_blocks
    assert ut.pool.allocator.used == uj.pool.allocator.used == 0
    np.testing.assert_allclose(ut.pool.k.numpy(), np.asarray(uj.pool.k),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ut.pool.v.numpy(), np.asarray(uj.pool.v),
                               rtol=2e-5, atol=2e-5)


def test_realtime_serve_completes_on_wall_clock():
    """The wall-clock mode (warm-up drain, calibrated solo-probe SLO
    references) serves a small trace to completion and frees the pool."""
    wl = tsynthesize(NAMES[:2], **TRACE)
    unit = TD.build_unit_from_specs(
        [(n, "qwen2-7b", wl.rates[n]) for n in NAMES[:2]], pool_blocks=4000,
        chunk_tokens=16, fused=True, dtype=torch.float32, device="cpu")
    rep = TD.serve_workload([unit], wl, seed=0, max_new_cap=4)
    assert not rep.deterministic
    assert rep.aggregate.finished == rep.aggregate.submitted > 0
    assert unit.pool.allocator.used == 0
    assert all(r.finish >= r.first_token >= r.arrival
               for r in unit.stats.finished)
