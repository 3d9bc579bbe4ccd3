"""Helper of the port's parity tests (not a test module): the JAX
package's model init, drawn once per model, example-batch shapes, seed and
``HYDRAGNN_*`` environment in a process. Flax's init depends on nothing
else, and tracing and compiling the same init again for every case is most
of a parity case's time. Each call returns fresh arrays: a JAX training
step donates its state's buffers.

``cached_jax_init`` is an autouse fixture for a module that builds many
JAX trainers: ``from _torch_jax_init import cached_jax_init  # noqa: F401``.
It also clears the JAX package's registered mesh for each case, which an
earlier test in the same worker may have left behind.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hydragnn_tpu.parallel.mesh as jax_mesh
import hydragnn_tpu.train.trainer as jax_trainer
from hydragnn_tpu.models.create import init_model_params

_CACHE = {}


def cached_init_model_params(model, batch, seed=0):
    shapes = tuple((tuple(np.shape(leaf)), str(np.asarray(leaf).dtype))
                   for leaf in jax.tree_util.tree_leaves(batch))
    env = tuple(sorted((k, v) for k, v in os.environ.items() if k.startswith("HYDRAGNN_")))
    key = (repr(model), shapes, int(seed), env)
    if key not in _CACHE:
        _CACHE[key] = jax.tree_util.tree_map(np.asarray, init_model_params(model, batch, seed=seed))
    return jax.tree_util.tree_map(jnp.array, _CACHE[key])


@pytest.fixture(autouse=True)
def cached_jax_init(monkeypatch):
    monkeypatch.setattr(jax_trainer, "init_model_params", cached_init_model_params)
    # each case starts from a fresh process's JAX mesh state: an earlier
    # test in the same worker may leave its mesh registered, and the JAX
    # loaders then pad the batches for that mesh's data axis while the
    # trainer shards them over the default one
    monkeypatch.setattr(jax_mesh, "_active_mesh", None)
