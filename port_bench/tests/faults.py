"""Faults planted in the program's timed path, for the tests that see
`correct` come out false."""

import torch


def unchanged_state(monkeypatch):
    """make_train_step's step returns the state it was given."""
    import drt_tpu_torch.optimize.loop as loop
    real = loop.make_train_step

    def make(*a, **kw):
        init, step, final = real(*a, **kw)

        def broken(state, *sa, **skw):
            _new, loss, aux = step(state, *sa, **skw)
            return state, loss, aux
        broken.ray_mesh = step.ray_mesh
        return init, broken, final
    monkeypatch.setattr(loop, "make_train_step", make)


def frozen_params(monkeypatch):
    """make_train_step's step updates the momentum (and the rest of the
    state) but leaves the parameters unwritten."""
    import drt_tpu_torch.optimize.loop as loop
    real = loop.make_train_step

    def make(*a, **kw):
        init, step, final = real(*a, **kw)

        def broken(state, *sa, **skw):
            new, loss, aux = step(state, *sa, **skw)
            return {**new, "params": state["params"]}, loss, aux
        broken.ray_mesh = step.ray_mesh
        return init, broken, final
    monkeypatch.setattr(loop, "make_train_step", make)


def half_batch(monkeypatch):
    """Half of the ray view's batch left out, the mean taken over the
    rest: every second matting-valid lane dropped, the sum scaled back."""
    import drt_tpu_torch.optimize.losses as losses
    real = losses.ray_loss

    def half(mesh, view, *a, **kw):
        sp, valid, mask, origin, rd, cam = view
        keep = valid & (torch.cumsum(valid.long(), 0) % 2 == 1)
        loss, st = real(mesh, (sp, keep, mask, origin, rd, cam), *a, **kw)
        return loss * (valid.sum() / keep.sum().clamp(min=1)), st
    monkeypatch.setattr(losses, "ray_loss", half)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "frozen_params": frozen_params}
