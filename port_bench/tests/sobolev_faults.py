"""Faults of the Sobolev parameterisation planted in the program, for the
tests that see them move a compared number or make `correct` false (the
reference plants the same two as its faults "adjoint" and "trips")."""


def adjoint_left_out(monkeypatch):
    """`sobolev_solve`'s backward passes the cotangent through: the
    gradient in v taken as the gradient in u, the adjoint solve left
    out."""
    from drt_tpu_torch.optimize import precondition
    monkeypatch.setattr(precondition._SobolevSolve, "backward", staticmethod(
        lambda ctx, g: (g, None, None, None, None, None, None)))


def trips_halved(monkeypatch):
    """`make_train_step` given half the configuration's trips, for the
    solve of the vertices and its adjoint alike."""
    import drt_tpu_torch.optimize.loop as loop
    real = loop.make_train_step

    def make(*a, cg_iters=64, **kw):
        return real(*a, cg_iters=cg_iters // 2, **kw)
    monkeypatch.setattr(loop, "make_train_step", make)


FAULTS = {"adjoint": adjoint_left_out, "trips": trips_halved}
