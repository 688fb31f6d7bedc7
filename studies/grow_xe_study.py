"""grow_cart's XE growth in the JAX package and in the port, on the CPU.

    python studies/grow_xe_study.py [S] [r] [CB]       (default 1024 6 4)
    python studies/grow_xe_study.py sens [S] [r] [CB]

The JAX package's `run_grow_cart` sizes its model from y's columns, which
XEBregman's C-1 logits cannot match, so this script drives the same loop
in both packages with their layer builders, `accumulating_sweep` and
`grow_cart` (1 -> 4 carriages, 3 swipes a step at eps 1.0 x 0.5,
XEBregman(1.0) on 9 logits, full batch), the port starting from the JAX
package's params and taking its grown conv blocks. It runs on
train_image's synthetic stand-in, as is and with chip_smoke's pixel noise
(`grow_stand_in`), and prints each step's ok flags, each package's
max|param|, train accuracy and the largest prediction difference over
max|pred|.

`sens` asks whether the packages part by rounding: on the noisy data,
after the JAX package's 1-carriage step and growth, it runs 1, 2 and 3
swipes of the 2-carriage step in both packages from the same params, and
in the port from those params each moved by a relative 1e-7 x N(0, 1), and
prints both prediction gaps over max|pred|.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tensornetworksfork_tpu.core.sweep import SweepConfig as JConfig  # noqa: E402
from tensornetworksfork_tpu.core.sweep import accumulating_sweep as jsweep  # noqa: E402
from tensornetworksfork_tpu.models import growing as jg  # noqa: E402
from tensornetworksfork_tpu.models.layers import TensorConvolutionTrainLayer as JLayer  # noqa: E402
from tensornetworksfork_tpu.ops.bregman import XEBregman as JXE  # noqa: E402
from tensornetworksfork_tpu_torch.core.sweep import SweepConfig, accumulating_sweep  # noqa: E402
from tensornetworksfork_tpu_torch.data.images import synthetic_image_classification  # noqa: E402
from tensornetworksfork_tpu_torch.models import growing as tg  # noqa: E402
from tensornetworksfork_tpu_torch.models.layers import TensorConvolutionTrainLayer  # noqa: E402
from tensornetworksfork_tpu_torch.ops.bregman import XEBregman  # noqa: E402
from tensornetworksfork_tpu_torch.utils.convert import params_from_numpy  # noqa: E402


def accuracy(logits, y):
    full = np.concatenate([logits, np.zeros_like(logits[:, :1])], 1)
    return float(np.mean(full.argmax(1) == y.argmax(1)))


def run(name, x, y, r, cb):
    xn, yn = x.numpy(), y.numpy()
    jl = JLayer(1, r, x.shape[1], x.shape[2], output_shape=(9,), convolution_bond=cb)
    tl = TensorConvolutionTrainLayer(1, r, x.shape[1], x.shape[2], output_shape=(9,),
                                     convolution_bond=cb, device="cpu")
    tl.params = params_from_numpy({k: np.asarray(v) for k, v in jl.params.items()},
                                  device="cpu")
    cfg = dict(num_swipes=3, method="ridge_cholesky", eps=1.0, eps_decay=0.5)
    for step in range(4):
        pj, okj = jsweep(jl.network, jl.params, jnp.asarray(xn), jnp.asarray(yn),
                         JXE(1.0), JConfig(**cfg))
        pt, okt = accumulating_sweep(tl.network, tl.params, x, y, XEBregman(1.0),
                                     SweepConfig(**cfg))
        jl.params, tl.params = pj, pt
        a, b = np.asarray(jl(jnp.asarray(xn))), tl(x).numpy()
        with np.errstate(invalid="ignore"):
            gap = float(np.abs(a - b).max() / np.abs(a).max())
        print(f"{name}, {step + 1} carriages: ok jax {okj} port {okt}; max|param| jax "
              f"{max(float(np.abs(np.asarray(v)).max()) for v in pj.values()):.3g} port "
              f"{max(float(v.abs().max()) for v in pt.values()):.3g}; train accuracy jax "
              f"{accuracy(a, yn):.4f} port {accuracy(b, yn):.4f}; max|d pred|/max|pred| "
              f"{gap:.3g}", flush=True)
        if step < 3:
            jl = jg.grow_cart(jl)
            grown = tg.grow_cart(tl)
            N = grown.num_carriages
            grown.params[f"C{N}"] = torch.tensor(np.asarray(jl.params[f"C{N}"]))
            tl = grown


def sensitivity(x, y, r, cb):
    xn, yn = x.numpy(), y.numpy()
    jl = JLayer(1, r, x.shape[1], x.shape[2], output_shape=(9,), convolution_bond=cb)
    cfg = dict(method="ridge_cholesky", eps=1.0, eps_decay=0.5)
    jl.params, _ = jsweep(jl.network, jl.params, jnp.asarray(xn), jnp.asarray(yn), JXE(1.0),
                          JConfig(num_swipes=3, **cfg))
    jl = jg.grow_cart(jl)
    tl = TensorConvolutionTrainLayer(2, r, x.shape[1], x.shape[2], output_shape=(9,),
                                     convolution_bond=cb, device="cpu")
    start = {k: np.asarray(v) for k, v in jl.params.items()}
    rng = np.random.default_rng(3)
    moved = {k: (v * (1 + 1e-7 * rng.standard_normal(v.shape))).astype(np.float32)
             for k, v in start.items()}

    def port(params, n):
        p, _ = accumulating_sweep(tl.network, params_from_numpy(params, device="cpu"), x, y,
                                  XEBregman(1.0), SweepConfig(num_swipes=n, **cfg))
        return tl(x, p).numpy()

    for n in (1, 2, 3):
        pj, _ = jsweep(jl.network, {k: jnp.asarray(v) for k, v in start.items()},
                       jnp.asarray(xn), jnp.asarray(yn), JXE(1.0), JConfig(num_swipes=n, **cfg))
        a, b, c = np.asarray(jl(jnp.asarray(xn), pj)), port(start, n), port(moved, n)
        m = np.abs(a).max()
        print(f"2 carriages, {n} swipes: max|d pred|/max|pred| jax vs port "
              f"{np.abs(a - b).max() / m:.3g}, port vs port from params moved by 1e-7 "
              f"{np.abs(b - c).max() / m:.3g}", flush=True)


def main(argv):
    sens = argv[:1] == ["sens"]
    argv = argv[1:] if sens else argv
    S, r, cb = (int(a) for a in (argv + ["1024", "6", "4"][len(argv):]))
    if sens:
        sensitivity(*cs.grow_stand_in(S), r, cb)
        return
    run("stand-in", *synthetic_image_classification(S=S, seed=0), r, cb)
    run(f"noise {cs.GROW_NOISE:g}", *cs.grow_stand_in(S), r, cb)


if __name__ == "__main__":
    main(sys.argv[1:])
