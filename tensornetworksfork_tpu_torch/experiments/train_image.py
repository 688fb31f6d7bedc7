"""The image trainer: conv-TT (type-I sum or one train) on MNIST-format data
(port of tensornetworksfork_tpu/experiments/train_image.py).

The reference's AAMNST protocol: configuration from environment variables,
a 90/10 validation split, a type-I sum of conv-TT members (members after the
first drop the bias patch row and pixel column), the XE loss with its logit
scale calibrated to w = 1/std(initial forward), early stopping on the
validation error rate with the best state restored, and the test accuracy
appended to a results CSV (default `build/image_results.csv`).

Data: MNIST/FashionMNIST idx or npz files, or CIFAR batches, staged under
DATA_PATH; sklearn's digits (DATASET=digits) from the copy committed with
the package; otherwise a shape-faithful synthetic stand-in. Nothing is
downloaded.

DEVICE selects the device of the model, the data and the sweep: the card
(`cuda`, the default) unless `cpu` is asked for; without a card `cuda`
raises. PRECISION=reference|fast|fastest selects the numerics tier
(utils/precision.py). METHOD=cg|minres|lanczos runs the matrix-free sweep
(MAX_ITER Krylov iterations a node), METHOD=gradient the gradient one.
PRESET=cifar_minres sets the reference's CIFAR_minres configuration: CIFAR10
(its 3-channel synthetic stand-in when no batches are staged), MINRES,
kernel 8/8, batch 4096, bf16 Gram operands and the bf16 aux tier; it fills
only the variables the caller has not set. Not ported: the JAX package's
`precompile` (nothing compiles here).

Run:  DATASET=MNIST N=4 R=18 CB=8 python -m tensornetworksfork_tpu_torch.experiments.train_image
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..core.sweep import Member, SweepConfig, Sweeper
from ..data.images import (DATASETS, load_cifar, load_digits_images,
                           load_mnist_like, preprocess_images,
                           synthetic_image_classification)
from ..models.estimators import EarlyStopping, error_rate
from ..models.layers import SumLayer, TensorConvolutionTrainLayer
from ..ops.bregman import XEBregman
from ..utils.device import resolve_device
from ..utils.metrics import accuracy, append_results_csv
from ..utils.precision import numerics_tier
from ..utils.timing import Timer

PRESETS = {
    # the reference's CIFAR_minres.py: CIFAR10, the matrix-free MINRES sweep,
    # bf16 operands (Gram and aux), kernel 8 / stride 8, batch 4096
    "cifar_minres": {"DATASET": "CIFAR10", "METHOD": "minres",
                     "KERNEL_SIZE": "8", "KERNEL_STRIDE": "8",
                     "BATCH_SIZE": "4096", "MAX_ITER": "50",
                     "TNF_GRAM_DTYPE": "bf16", "TNF_AUX_PRECISION": "default"},
}


def get_config_from_env():
    """The JAX package's configuration, key for key, plus DEVICE.
    PRESET=<name> fills the variables of PRESETS[name] that are not set
    (os.environ.setdefault, as in the JAX package)."""
    preset = os.environ.get("PRESET", "").lower()
    if preset:
        if preset not in PRESETS:
            raise ValueError(f"unknown PRESET {preset!r}; valid: "
                             f"{sorted(PRESETS)}")
        for k, v in PRESETS[preset].items():
            os.environ.setdefault(k, v)
    e = os.environ.get
    ds_info = DATASETS.get(e("DATASET", "MNIST").lower(), {})
    dk = str(ds_info.get("default_kernel", 4))
    dstr = str(ds_info.get("default_stride", 4))
    config = {
        "dataset": e("DATASET", "MNIST"),
        "data_path": e("DATA_PATH", "data/" + e("DATASET", "MNIST")),
        "model_type": e("MODEL_TYPE", "tt_type1"),
        "N": int(e("N", "4")),
        "r": int(e("R", "10")),
        "CB": int(e("CB", "4")),
        "seed": int(e("SEED", "42")),
        "kernel_size": int(e("KERNEL_SIZE", dk)),
        "kernel_stride": int(e("KERNEL_STRIDE", dstr)),
        "num_swipes": int(e("NUM_SWIPES", "5")),
        "method": e("METHOD", "ridge_cholesky"),
        "max_iter": int(e("MAX_ITER", "50")),
        "eps": float(e("EPS", "5.0")),
        "eps_decay": float(e("EPS_DECAY", "0.25")),
        "batch_size": int(e("BATCH_SIZE", "2048")),
        "early_stopping": int(e("EARLY_STOPPING", "10")),
        "abs_err": float(e("ABS_ERR", "1e-4")),
        "rel_err": float(e("REL_ERR", "1e-3")),
        "validation_split": float(e("VALIDATION_SPLIT", "0.1")),
        "verbose": int(e("VERBOSE", "1")),
        "results_file": e("RESULTS_FILE", "build/image_results.csv"),
        "synthetic_samples": int(e("SYNTHETIC_SAMPLES", "8192")),
        # reference | fast | fastest | "" = respect the TNF_* env
        "precision": e("PRECISION", "") or None,
        "device": e("DEVICE", "cuda"),
    }
    return config


def load_data(config):
    """(x_train, y_train, x_test, y_test, synthetic) as CPU tensors."""
    if config["dataset"].lower() == "digits":
        # the train/test partition uses a fixed protocol seed, not the run
        # seed, so every seed is tested on the same rows; run seeds drive
        # the init and the validation split
        k = min(config["kernel_size"], 4)
        split_seed = int(os.environ.get("TEST_SPLIT_SEED", "42"))
        xtr, ytr, xte, yte = load_digits_images(k, k, seed=split_seed)
        return xtr, ytr, xte, yte, False
    name = config["dataset"].lower()
    info = DATASETS.get(name, DATASETS["mnist"])
    mean, std = info["normalize"]
    try:
        if name.startswith("cifar"):
            xtr, ytr, xte, yte = load_cifar(config["data_path"],
                                            info["num_classes"])
        else:
            xtr, ytr, xte, yte = load_mnist_like(config["data_path"])
        xin_tr, y_tr = preprocess_images(
            xtr, ytr, config["kernel_size"], config["kernel_stride"],
            num_classes=info["num_classes"], mean=mean, std=std)
        xin_te, y_te = preprocess_images(
            xte, yte, config["kernel_size"], config["kernel_stride"],
            num_classes=info["num_classes"], mean=mean, std=std)
        synthetic = False
    except FileNotFoundError:
        if config["verbose"]:
            print("no local image data found; using synthetic stand-in",
                  file=sys.stderr)
        S = config["synthetic_samples"]
        n_test = max(S // 6, 512)
        x_all, y_all = synthetic_image_classification(
            S + n_test, side=info.get("side", 28),
            num_classes=info["num_classes"],
            kernel_size=config["kernel_size"],
            kernel_stride=config["kernel_stride"], seed=config["seed"],
            channels=info.get("channels", 1))
        xin_tr, y_tr = x_all[:S], y_all[:S]
        xin_te, y_te = x_all[S:], y_all[S:]
        synthetic = True
    return xin_tr, y_tr, xin_te, y_te, synthetic


def build_model(config, num_patches, patch_pixels, n_out):
    device = config.get("device", "cuda")
    if "type1" in config["model_type"]:
        layers = []
        for i in range(1, config["N"] + 1):
            P = num_patches if i == 1 else num_patches - 1
            pp = patch_pixels if i == 1 else patch_pixels - 1
            layers.append(TensorConvolutionTrainLayer(
                num_carriages=i, bond_dim=config["r"], num_patches=P,
                patch_pixels=pp, output_shape=(n_out - 1,),
                convolution_bond=config["CB"], seed=config["seed"] + i,
                device=device))
        return SumLayer(layers)
    layer = TensorConvolutionTrainLayer(
        num_carriages=config["N"], bond_dim=config["r"],
        num_patches=num_patches, patch_pixels=patch_pixels,
        output_shape=(n_out - 1,), convolution_bond=config["CB"],
        seed=config["seed"], device=device)
    return SumLayer([layer])


def train_model(config):
    with numerics_tier(config.get("precision")):
        return _train_model(config)


def _train_model(config):
    np.random.seed(config["seed"])
    dev = resolve_device(config.get("device", "cuda"))
    xin_tr, y_tr, xin_te, y_te, synthetic = load_data(config)
    n = xin_tr.shape[0]
    idx = np.arange(n)
    rng = np.random.RandomState(config["seed"])
    rng.shuffle(idx)
    split = int(n * (1 - config["validation_split"]))
    tr, va = torch.from_numpy(idx[:split]), torch.from_numpy(idx[split:])
    xin_val, y_val = xin_tr[va].to(dev), y_tr[va].numpy()
    xin_tr, y_tr = xin_tr[tr].to(dev), y_tr[tr].to(dev)
    xin_te = xin_te.to(dev)

    model = build_model(dict(config, device=dev), xin_tr.shape[1],
                        xin_tr.shape[2], int(y_tr.shape[1]))
    if config["verbose"]:
        print("Num params:", model.num_parameters())

    # logit-scale calibration (reference AAMNST.py:192-195)
    y0 = model(xin_tr[:64]).cpu().numpy()
    w = float(1.0 / max(y0.std(), 1e-8))
    bf = XEBregman(w=w)

    cfg = SweepConfig(num_swipes=config["num_swipes"],
                      batch_size=config["batch_size"],
                      method=config.get("method", "ridge_cholesky"),
                      max_iter=config.get("max_iter", 50),
                      eps=config["eps"], eps_decay=config["eps_decay"],
                      verbose=config["verbose"])
    members = [Member(l.network, fn)
               for l, fn in zip(model.layers, model.input_fns)]
    sweeper = Sweeper(members, bf, cfg)

    def sync():
        pl = getattr(sweeper, "params_list", None)
        if pl is not None:
            model.set_params_list(pl)

    # evaluation at a smaller batch than training (the one-shot forward's
    # intermediates grow with the batch); EVAL_BATCH overrides
    eval_batch = int(os.environ.get(
        "EVAL_BATCH", str(min(config["batch_size"], 1024))))

    def model_predict(x):
        """Logits with the reference's zero column for the last class, as
        a numpy array on the host."""
        sync()
        y = model.forward_batch(x, eval_batch)
        return torch.cat([y, torch.zeros_like(y[:, :1])], dim=1).cpu().numpy()

    stopper = EarlyStopping(
        xin_val, y_val, model_predict=model_predict,
        get_model_weights=lambda: (sync() or model.node_states()),
        loss_fn=error_rate, abs_err=config["abs_err"],
        rel_err=config["rel_err"], early_stopping=config["early_stopping"],
        verbose=config["verbose"])

    timer = Timer()
    with timer.phase("train"):
        params_list, ok = sweeper.run(
            model.params_list, xin_tr, y_tr,
            convergence_criterion=stopper.convergence_criterion)
    model.set_params_list(params_list)
    if stopper.best_state_dict is not None:
        model.load_node_states(stopper.best_state_dict)

    y_pred = model_predict(xin_te)
    acc = accuracy(y_te.numpy(), y_pred)
    if config["verbose"]:
        print(f"Test Accuracy: {acc*100:.2f}% "
              f"(train {timer.totals['train']:.1f}s, "
              f"{stopper.epoch} eval epochs, singular={not ok})")
    return {
        "dataset": config["dataset"] + ("-synthetic" if synthetic else ""),
        "model_type": config["model_type"],
        "N": config["N"], "r": config["r"], "CB": config["CB"],
        "test_accuracy": round(acc * 100, 2),
        "num_parameters": model.num_parameters(),
        "num_swipes": config["num_swipes"], "eps": config["eps"],
        "method": config.get("method", "ridge_cholesky"),
        "precision": config.get("precision") or "",
        "eps_decay": config["eps_decay"],
        "kernel_size": config["kernel_size"],
        "kernel_stride": config["kernel_stride"],
        "early_stopping": config["early_stopping"],
        "abs_err": config["abs_err"], "rel_err": config["rel_err"],
        "seed": config["seed"],
        "validation_split": config["validation_split"],
        "train_seconds": round(timer.totals["train"], 2),
        "singular": not ok,
    }


def main():
    config = get_config_from_env()
    if config["verbose"]:
        for k, v in config.items():
            print(f"{k}: {v}")
    results = train_model(config)
    append_results_csv(results, config["results_file"])
    if config["verbose"]:
        print("Training completed successfully!")


if __name__ == "__main__":
    main()
