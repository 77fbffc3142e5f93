"""The port's MoE family and the new attention shapes served against the
JAX package, on the CPU.

Served parity under the deterministic ``TickCostModel`` clock, the JAX
package's float32 weights (``PRNGKey(i)``) carried across with
``params_to_torch``: every request's greedy tokens are equal,
``ServeReport.to_json()`` is equal apart from ``wall_s``, the pools are
freed and agree within 2e-5 (float32; the frameworks sum in different
orders).  Units:

* reduced granite-moe-3b-a800m beside reduced qwen2-7b (chunked prefill,
  fused ADBS: the dense pair fuses, the MoE engines tick serially, as
  the reference's ``fusion_signature`` has it);
* reduced qwen3-moe-235b-a22b (QK-norm) beside reduced musicgen-medium
  (audio, served as a token decoder), whole-prompt prefill;
* a head_dim-96 variant: two reduced phi-3-vision-4.2b at d_model 384
  (4 heads of 96), fused, chunked and whole-prompt;
* a group-16 variant: reduced qwen2-7b with 16 query heads of 64 over
  one kv head, chunked and whole-prompt.

The reference's ``build_unit_from_specs`` pins its pool at head_dim 64,
so the variants' units are assembled in both packages from
``UnifiedKVPool``, ``Engine`` and ``MuxScheduler`` as that function
does (quota ∝ rate).  On the CPU the attention runs the kernels' plain
versions; the kernels at these shapes are held to them on the card
(``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.core.workload import synthesize as jsynthesize
from repro.models.transformer import init_params as jinit
from repro.serving import driver as JD
from repro.serving import engine as JE
from repro.serving import kvcache as JK
from repro.serving import mux as JMX
from repro_torch import config as tconfig
from repro_torch.core.workload import synthesize as tsynthesize
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import driver as TD
from repro_torch.serving import engine as TE
from repro_torch.serving import kvcache as TK
from repro_torch.serving import mux as TMX

torch.set_num_threads(2)
POOL = 4000


def _units(cfgs, rates, chunk):
    """One colocated unit per package over ``cfgs`` (reference configs;
    the port's are the same dataclass fields), as
    ``build_unit_from_specs`` assembles it, the reference's weights in
    both."""
    hd = {c.hd for c in cfgs}
    assert len(hd) == 1
    hd = hd.pop()
    jpool = JK.UnifiedKVPool(POOL, hd, dtype=jnp.float32)
    tpool = TK.UnifiedKVPool(POOL, hd, dtype=torch.float32, device="cpu")
    rate_sum = sum(rates)
    min_quota = max(POOL // (8 * len(cfgs)), 1)
    jeng, teng = {}, {}
    for i, (cfg, rate) in enumerate(zip(cfgs, rates)):
        quota = max(int(POOL * rate / rate_sum), min_quota)
        jp = jinit(jax.random.PRNGKey(i), cfg, jnp.float32)
        tp = params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
        tcfg = tconfig.ModelConfig(**{
            k: getattr(cfg, k) for k in cfg.__dataclass_fields__
            if k not in ("moe", "ssm")},
            moe=None if cfg.moe is None else tconfig.MoEConfig(
                **vars(cfg.moe)))
        jeng[cfg.name] = JE.Engine(cfg, jp, jpool.register_model(cfg, quota),
                                   max_slots=4, chunk_tokens=chunk or None)
        teng[cfg.name] = TE.Engine(tcfg, tp,
                                   tpool.register_model(tcfg, quota),
                                   max_slots=4, chunk_tokens=chunk or None)
    return (JMX.MuxScheduler(jeng, jpool, policy="adbs", fused=True),
            TMX.MuxScheduler(teng, tpool, policy="adbs", fused=True))


def _serve_both(cfgs, chunk, alpha=1.0, max_rate=12.0):
    names = [c.name for c in cfgs]
    trace = dict(alpha=alpha, max_rate=max_rate, horizon=1.0, seed=0,
                 mean_prompt=24, mean_output=8, max_len=128)
    wl_j, wl_t = jsynthesize(names, **trace), tsynthesize(names, **trace)
    uj, ut = _units(cfgs, [wl_j.rates[n] for n in names], chunk)
    rj = JD.serve_workload([uj], wl_j, seed=0, cost=JD.TickCostModel())
    rt = TD.serve_workload([ut], wl_t, seed=0, cost=TD.TickCostModel())
    return wl_j, uj, ut, rj, rt


def _assert_same(wl_j, uj, ut, rj, rt):
    assert [g.names for g in ut.fused_groups] == \
        [g.names for g in uj.fused_groups]
    assert sorted(ut._serial_names) == sorted(uj._serial_names)
    tok_j = {r.req_id: r.output for r in uj.stats.finished}
    tok_t = {r.req_id: r.output for r in ut.stats.finished}
    assert len(tok_j) == len(wl_j.requests) > 5
    assert tok_t == tok_j
    a, b = rj.to_json(), rt.to_json()
    a.pop("wall_s")
    b.pop("wall_s")
    assert b == a
    assert ut.pool.allocator.used == uj.pool.allocator.used == 0
    np.testing.assert_allclose(ut.pool.k.numpy(), np.asarray(uj.pool.k),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ut.pool.v.numpy(), np.asarray(uj.pool.v),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("archs,chunk", [
    (("granite-moe-3b-a800m", "qwen2-7b", "qwen2-7b"), 16),
    (("qwen3-moe-235b-a22b", "musicgen-medium"), 0),
])
def test_moe_units_serve_as_the_reference(archs, chunk):
    cfgs = [jconfig.replace(jconfigs.get_reduced(a), name=f"{a}#{i}")
            for i, a in enumerate(archs)]
    wl_j, uj, ut, rj, rt = _serve_both(cfgs, chunk)
    per_model = {c.name: sum(r.model == c.name for r in wl_j.requests)
                 for c in cfgs}
    assert min(per_model.values()) >= 3, per_model
    moe = [c.name for c in cfgs if c.family == "moe"]
    assert set(moe) <= set(ut._serial_names)
    _assert_same(wl_j, uj, ut, rj, rt)


@pytest.mark.parametrize("chunk", [16, 0])
def test_head_dim_96_pair_serves_as_the_reference(chunk):
    cfgs = [jconfig.replace(jconfigs.get_reduced("phi-3-vision-4.2b"),
                            name=f"phi{i}", d_model=384) for i in range(2)]
    assert cfgs[0].hd == 96
    wl_j, uj, ut, rj, rt = _serve_both(cfgs, chunk)
    assert len(ut.fused_groups) == 1
    _assert_same(wl_j, uj, ut, rj, rt)


@pytest.mark.parametrize("chunk", [16, 0])
def test_group_16_serves_as_the_reference(chunk):
    cfg = jconfig.replace(jconfigs.get_reduced("qwen2-7b"), name="g16",
                          n_heads=16, n_kv_heads=1, head_dim=64)
    assert cfg.hd == 64 and cfg.n_heads // cfg.n_kv_heads == 16
    other = jconfig.replace(jconfigs.get_reduced("granite-moe-3b-a800m"),
                            name="moe")
    wl_j, uj, ut, rj, rt = _serve_both([cfg, other], chunk)
    _assert_same(wl_j, uj, ut, rj, rt)
