"""Every optimizer / preconditioner pair of make_train_step against the
JAX package: two float64 compat steps from identical state (the JAX
optimizer state carried across with drt_tpu_torch.convert), losses and final
vertices at rtol 1e-7 (atol 1e-7 of the largest coordinate), the optimizer
state at the same tolerance. The setup is tests/test_torch_train.py's, whose
first test asserts that both oracles pick the same triangles on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drt_tpu.intersect import get_intersect_fn as j_get_fn
from drt_tpu.optimize.losses import LossWeights as JW
from drt_tpu.optimize.loop import make_train_step as j_make_step
from drt_tpu_torch.convert import (mesh_state_from_arrays,
                                   train_state_from_arrays,
                                   view_batch_from_arrays)
from drt_tpu_torch.intersect import get_intersect_fn as t_get_fn
from drt_tpu_torch.optimize import (LossWeights, default_silhouette_budget,
                                    make_train_step)
from tests.test_torch_train import (HP, RAY_VIEWS, RES, SILH, _jax_state,
                                    _weights, setup)  # noqa: F401

# The test workers run side by side on few cores: torch's intra-op pool at
# its default size oversubscribes them and slows every worker down.
torch.set_num_threads(min(2, torch.get_num_threads()))

STATE_KEYS = ("params", "m", "v", "v_per", "count", "init_v", "silh_max")
PAIRS = [("adam", "none"), ("uadam", "none"), ("sgd", "sobolev"),
         ("uadam", "sobolev"), ("sgd", "h1"), ("uadam", "h1")]
KW = dict(precond_lambda=9.0, cg_iters=64)


def _close(t, j, what):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(np.asarray(t, np.float64), j, rtol=1e-7,
                               atol=1e-7 * max(np.abs(j).max(), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("optimizer,precond", PAIRS)
def test_two_steps_match_jax(setup, optimizer, precond):  # noqa: F811
    views, mesh = setup
    budget = default_silhouette_budget(mesh["num_edges"])
    lr = 0.02
    with jax.enable_x64(True):
        jv, jms = _jax_state(views, mesh)
        init, step, final = j_make_step(
            j_get_fn("brute"), _weights(JW), *RES, budget,
            optimizer=optimizer, precond=precond, **KW)
        st = init(jms)
        carried = {k: np.asarray(st[k]) for k in STATE_KEYS}
        jlosses, jaux = [], None
        for i in RAY_VIEWS:
            st, loss, jaux = step(st, jnp.asarray(lr, jnp.float64), jms, jv,
                                  jnp.asarray([i]), jnp.asarray(SILH))
            jlosses.append(float(loss))
        jst = {k: np.asarray(st[k]) for k in STATE_KEYS}
        jverts = np.asarray(final(st, jms))
        jaux = {k: np.asarray(v) for k, v in jaux.items()}

    tms = mesh_state_from_arrays(mesh, "cpu")
    tv = view_batch_from_arrays(views, "cpu")
    init, step, final = make_train_step(
        t_get_fn("auto"), _weights(LossWeights), *RES, budget,
        optimizer=optimizer, precond=precond, **KW)
    own = init(tms)
    assert set(own) == set(STATE_KEYS)
    for k in STATE_KEYS:                      # the port's own initial state
        _close(own[k], carried[k], f"init {k}")
    st = train_state_from_arrays(carried, "cpu")
    tlosses = []
    for i in RAY_VIEWS:
        prev = st
        st, loss, aux = step(st, lr, tms, tv, [i], SILH)
        assert st is not prev and prev["params"] is not st["params"]
        tlosses.append(float(loss))
    _close(tlosses, jlosses, "losses")
    for k in STATE_KEYS:
        _close(st[k], jst[k], f"state {k}")
    assert int(st["count"]) == (0 if optimizer == "sgd" else len(RAY_VIEWS))
    assert int(st["silh_max"]) > 0
    tverts = final(st, tms).numpy()
    assert np.abs(tverts - mesh["vertices"]).max() > 1e-4
    _close(tverts, jverts, "vertices")
    assert set(aux) == set(jaux)
    # The counters of lanes that die on the way are left out: a grazing lane
    # may die at another bounce under the other float32 oracle (see
    # test_torch_train.test_hit_ids_agree); the rays that reach the loss
    # are the same.
    for k in set(jaux) - {"active_after_bounce1", "active_after_bounce2",
                          "dropped_bounce1", "dropped_bounce2",
                          "occluded_exit"}:
        _close(aux[k], jaux[k], f"aux {k}")


def test_unit_lr_tensor_and_float_agree(setup):  # noqa: F811
    """`lr` may be a float or a 0-d tensor."""
    views, mesh = setup
    tms = mesh_state_from_arrays(mesh, "cpu")
    tv = view_batch_from_arrays(views, "cpu")
    init, step, _ = make_train_step(
        t_get_fn("auto"), _weights(LossWeights), *RES, 512,
        optimizer="uadam")
    a, _, _ = step(init(tms), 0.05, tms, tv, 1, SILH)
    b, _, _ = step(init(tms), torch.tensor(0.05, dtype=torch.float64), tms,
                   tv, 1, SILH)
    assert torch.equal(a["params"], b["params"])


def test_clamp_rule_and_rejections(setup):  # noqa: F811
    """The +-1 clamp applies to sgd + none and to h1 under every optimizer,
    and to nothing else (drt_tpu/optimize/loop.py:88-89); h1 without a ray
    weight, and unknown names, raise."""
    views, mesh = setup
    tms = mesh_state_from_arrays(mesh, "cpu")
    tv = view_batch_from_arrays(views, "cpu")
    big = _weights(LossWeights)._replace(ray_w=4e4)
    for optimizer, precond, clamped in [("sgd", "none", True),
                                        ("adam", "none", False),
                                        ("adam", "h1", True),
                                        ("sgd", "sobolev", False),
                                        ("uadam", "sobolev", False)]:
        init, step, _ = make_train_step(
            t_get_fn("auto"), big, *RES, 512, optimizer=optimizer,
            precond=precond, precond_lambda=0.01, cg_iters=8)
        _, _, aux = step(init(tms), 0.0, tms, tv, 1, SILH)
        assert (float(aux["max_grad"]) <= 1.0) == clamped, (optimizer,
                                                            precond)
    with pytest.raises(ValueError, match="nonzero ray_w"):
        make_train_step(t_get_fn("auto"), big._replace(ray_w=0.0), *RES, 512,
                        precond="h1")
    with pytest.raises(ValueError):
        make_train_step(t_get_fn("auto"), big, *RES, 512, optimizer="lion")
    with pytest.raises(ValueError):
        make_train_step(t_get_fn("auto"), big, *RES, 512, precond="h2")
