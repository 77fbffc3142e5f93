"""Twin units for the port's parity tests: the same colocated unit built
by the JAX package and by the port, the port's engines carrying the JAX
package's weights (``params_to_torch``, float32, on the CPU), so the
two serve the same trace to equal tokens and reports."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.config import replace as jreplace
from repro.models.transformer import init_params as jinit
from repro.serving import driver as JD
from repro_torch.models.transformer import params_to_torch
from repro_torch.serving import driver as TD

CPU = dict(dtype=torch.float32, device="cpu")


def reference_trees(specs, seed=0):
    """The JAX package's weights of ``build_unit_from_specs(specs,
    seed=seed)`` (spec ``i`` from ``PRNGKey(seed + i)``), as the port's
    trees."""
    trees = []
    for i, (name, arch, _) in enumerate(specs):
        cfg = jreplace(jconfigs.get_reduced(arch), name=name)
        tree = jinit(jax.random.PRNGKey(seed + i), cfg, jnp.float32)
        trees.append(params_to_torch(
            jax.tree_util.tree_map(np.asarray, tree), "cpu"))
    return trees


def twin_units(specs, seed=0, **kw):
    """``(jax_unit, port_unit)`` of ``build_unit_from_specs(specs, **kw)``
    with equal weights."""
    uj = JD.build_unit_from_specs(specs, seed=seed, **kw)
    ut = TD.build_unit_from_specs(specs, seed=seed,
                                  params=reference_trees(specs, seed),
                                  **CPU, **kw)
    return uj, ut


def report_text(rep, wall=("wall_s",)):
    """``rep.to_json()`` without the fields that read a real wall clock,
    as canonical JSON text: a replica that finished nothing has NaN
    latency percentiles, and NaN never equals NaN in a dict compare,
    while its JSON text does."""
    d = rep.to_json()
    for k in wall:
        d.pop(k)
    return json.dumps(d, sort_keys=True)


def placement_trees(pl, seed=0):
    """The JAX package's weights of ``units_from_placement(pl,
    seed=seed)`` (mesh ``m`` builds its unit with seed ``seed +
    m.mesh_id``), by spec name, as the port's trees."""
    trees = {}
    for m in pl.meshes:
        specs = [(s.name, s.arch_id, s.rate) for s in m.specs]
        trees.update(zip((s[0] for s in specs),
                         reference_trees(specs, seed + m.mesh_id)))
    return trees
