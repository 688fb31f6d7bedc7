"""Where f32 rounding alone parts two runs of the same fit, on the CPU.

    python studies/conditioning_study.py default_train
    python studies/conditioning_study.py mlp

`default_train`: the JAX package's `default_train.run` and the port's, the
port from the JAX package's initial params (read where the JAX module calls
accumulating_sweep), predictions read where each package scores them. It
prints the largest prediction difference over max|pred| for the raw
variant (S=512, d=3, degree 2, N=3, r=6, one swipe) at eps 1e-4 and 1e-2,
and for the uncertainty head (S=2,048, default_train's defaults) after 1 to 8
swipes, with each package's train RMSE.

`mlp`: the port's MLPWrapper on breast_cancer (seed 42's split, the default
64-64 MLP, lr 0.1), its initial weights scaled by (1 + delta N(0, 1)) for
delta in 0, 1e-7, 1e-6, fitted for 50 and for 5 epochs: the final train
loss of each, so the spread that rounding-sized changes give is read off.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_train_study():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from tensornetworksfork_tpu.core.sweep import accumulating_sweep as jsweep
    from tensornetworksfork_tpu.experiments import default_train as jdt
    from tensornetworksfork_tpu_torch.core.sweep import accumulating_sweep as tsweep
    from tensornetworksfork_tpu_torch.experiments import default_train as tdt
    from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy

    seen = {}

    def spy(mod, key, base):
        def sweep(net, params, *a, **k):
            if key == "jax":
                seen["init"] = {n: np.asarray(v) for n, v in params.items()}
            else:
                params = params_from_numpy(seen["init"], device="cpu")
            return base(net, params, *a, **k)

        def score(y, pred):
            seen[key] = np.asarray(pred)
            return float(np.sqrt(np.mean((np.asarray(y) - np.asarray(pred)) ** 2)))
        mod.accumulating_sweep, mod.rmse = sweep, score

    spy(jdt, "jax", jsweep)
    spy(tdt, "port", tsweep)

    def gap():
        return float(np.abs(seen["jax"] - seen["port"]).max() / np.abs(seen["jax"]).max())

    for eps in (1e-4, 1e-2):
        kw = dict(S=512, d=3, degree=2, N=3, r=6, num_swipes=1, eps=eps)
        jdt.run("raw", **kw)
        tdt.run("raw", device="cpu", **kw)
        print(f"raw, one swipe, eps {eps:g}: max|d pred|/max|pred| {gap():.3g}", flush=True)
    for swipes in range(1, 9):
        rj = jdt.run("uncertainty", S=2048, num_swipes=swipes)
        rt = tdt.run("uncertainty", S=2048, num_swipes=swipes, device="cpu")
        print(f"uncertainty, {swipes} swipes: train rmse jax {rj['train_rmse']:.6g} port "
              f"{rt['train_rmse']:.6g}, max|d pred|/max|pred| {gap():.3g}", flush=True)


def mlp_study():
    import torch
    from tensornetworksfork_tpu_torch.data.tabular import load_sklearn_dataset
    from tensornetworksfork_tpu_torch.models import baselines as B

    bc = load_sklearn_dataset("breast_cancer", seed=42)
    y = bc["y_train"].reshape(-1).astype(int)
    base = B.MLP(bc["X_train"].shape[1], 2, (64, 64), seed=0).state_dict()
    for epochs in (50, 5):
        for delta in (0.0, 1e-7, 1e-6):
            gen = torch.Generator().manual_seed(1)
            state = {k: v * (1 + delta * torch.randn(v.shape, generator=gen))
                     for k, v in base.items()}
            m = B.MLPWrapper(bc["X_train"].shape[1], 2, dict(epochs=epochs),
                             task="classification", device="cpu")
            build = m._build
            m._build = lambda X, build=build, state=state: _loaded(build(X), state)
            m.fit(bc["X_train"], y)
            print(f"mlp, {epochs} epochs, init x (1 + {delta:g} N(0,1)): final train loss "
                  f"{m.final_loss_:.6g}", flush=True)


def _loaded(model, state):
    model.load_state_dict(state)
    return model


if __name__ == "__main__":
    {"default_train": default_train_study, "mlp": mlp_study}[sys.argv[1]]()
