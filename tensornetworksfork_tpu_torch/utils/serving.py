"""Serving exports (port of tensornetworksfork_tpu/utils/serving.py): a
trained model compiled into a self-contained artifact that serves without
the package's code.

The JAX package exports StableHLO (`jax.export`); the port exports a
`torch.export` program and writes it with `torch.export.save`: the traced
forward graph of aten operations with the node tensors inside it, so
`load_forward` needs `torch` alone. Classification artifacts reproduce
`predict`: the bias feature appended, and the zero logit appended to the
C-1 model outputs.

    blob = export_estimator(reg)                      # a fitted estimator
    f = load_forward(blob)                            # anywhere, later
    probs = f(X)                                      # any batch size

`export_forward` is the layer-level variant for TNLayer / SumLayer models
(its input is what the layer's __call__ takes, e.g. patch tensors for
conv-TT image models) and for any callable of one tensor built from them.
The layers are not `nn.Module`s: a serving module holds each member's node
tensors as buffers and calls `layer(x, params=...)` with them, so the
params are the artifact's state and not constants folded into its graph.
With `batch_polymorphic` the batch dimension is a `torch.export.Dim`: the
contraction plan is made from the trace's example batch (EXAMPLE_BATCH
rows; torch.export specialises a dimension whose example is 1) and does
not guard on it, so one artifact serves every batch size, 1 included. The JAX package's `platforms=` becomes `device=`: the device
the artifact's tensors live on, and the one its inputs must be on.
"""
from __future__ import annotations

import contextlib
import io
import os
from typing import Sequence, Union

import torch

from .device import resolve_device

EXAMPLE_BATCH = 1024  # rows of the trace's example input when batch_polymorphic


def _members(model):
    """The TNLayers whose params the serving module holds, and how model
    takes them: "sum" (a SumLayer's params_list), "layer" (params=) or None
    (a callable closing over its tensors)."""
    from ..models.layers import SumLayer, TNLayer
    if isinstance(model, SumLayer):
        return list(model.layers), "sum"
    if isinstance(model, TNLayer):
        return [model], "layer"
    return [], None


class ServingModule(torch.nn.Module):
    """The traced serving computation: the model's forward (+ the bias
    column, + the appended zero logit for classification), with every
    member's node tensors registered as buffers."""

    def __init__(self, model, classification: bool = False, add_bias: bool = False,
                 device="cuda", embed=None):
        super().__init__()
        dev = resolve_device(device)
        self.model = model
        self.classification = classification
        self.add_bias = add_bias
        self.embed = embed  # a feature map of the rows, traced in (TNML)
        layers, self._kind = _members(model)
        self._buffers_of = []
        for i, layer in enumerate(layers):
            names = {}
            for j, (k, v) in enumerate(layer.params.items()):
                names[k] = f"m{i}_p{j}"
                self.register_buffer(names[k], v.detach().to(dev))
            self._buffers_of.append(names)

    def forward(self, x):
        if self.add_bias:
            x = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        if self.embed is not None:
            x = self.embed(x)
        params = [{k: getattr(self, b) for k, b in names.items()}
                  for names in self._buffers_of]
        if self._kind == "sum":
            y = self.model(x, params_list=params)
        elif self._kind == "layer":
            y = self.model(x, params=params[0])
        else:
            y = self.model(x)
        if self.classification:
            y = torch.cat([y, torch.zeros_like(y[..., :1])], dim=-1)
        return y


def export_forward(model, feature_shape: Sequence[int], *,
                   classification: bool = False, add_bias: bool = False,
                   dtype=torch.float32, device="cuda",
                   batch_polymorphic: bool = True) -> bytes:
    """Export a trained TNLayer / SumLayer (or a callable of them) to a
    serialized `torch.export` program.

    feature_shape: the per-sample input shape, x.shape[1:] of what the
    model's __call__ takes (features for tabular TT, (patches,
    patch_pixels) for conv-TT). The batch dim is symbolic when
    batch_polymorphic (one artifact serves any batch size; the trace runs
    on EXAMPLE_BATCH fake rows, which set the contraction plan); otherwise
    pass the fixed batch size as the first entry of feature_shape and it is
    used verbatim. A SumLayer whose members read one global input shares
    that input's batch dimension."""
    dev = resolve_device(device)
    mod = ServingModule(model, classification, add_bias, dev)
    return export_module(mod, feature_shape, dtype=dtype, device=dev,
                         batch_polymorphic=batch_polymorphic)


def export_module(mod: torch.nn.Module, feature_shape: Sequence[int], *,
                  dtype=torch.float32, device="cuda", batch_polymorphic: bool = True
                  ) -> bytes:
    """`export_forward`'s trace and serialisation of a serving module."""
    dev = resolve_device(device)
    mod = mod.eval()
    if batch_polymorphic:
        shape = (EXAMPLE_BATCH, *feature_shape)
        dynamic = ({0: torch.export.Dim("batch")},)
    else:
        shape, dynamic = tuple(feature_shape), None
    example = torch.zeros(shape, dtype=dtype, device=dev)
    with torch.no_grad():
        ep = torch.export.export(mod, (example,), dynamic_shapes=dynamic, strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_estimator(reg, *, device=None, batch_polymorphic: bool = True) -> bytes:
    """Export a FITTED TensorTrainRegressor-style estimator: the artifact
    takes raw (B, n_features) rows and reproduces estimator.predict: bias
    column appended, zero logit appended for classification. `device`
    defaults to the estimator's."""
    if getattr(reg, "_model", None) is None or reg.input_dim is None:
        raise ValueError("estimator must be fitted before export")
    return export_forward(
        reg._model, (reg.input_dim - 1,),  # input_dim counts the bias column
        classification=(reg.task == "classification"), add_bias=True,
        dtype=reg.dtype, device=reg.device if device is None else device,
        batch_polymorphic=batch_polymorphic)


def load_forward(blob: Union[bytes, str]):
    """Deserialize a serving artifact (bytes, or a path to one) into a
    callable of one tensor. Needs only torch: no code of this package. The
    callable's `device` is the device the artifact's tensors live on; a
    numpy or CPU input is moved there. Under a running `torch.profiler`, with
    TNF_SPANS=1 in the environment, a call is the span `tnf.serve.call`."""
    src = io.BytesIO(blob) if isinstance(blob, (bytes, bytearray)) else os.fspath(blob)
    ep = torch.export.load(src)
    module = ep.module()
    state = list(ep.state_dict.values()) + list(ep.constants.values())
    device = next((t.device for t in state if isinstance(t, torch.Tensor)),
                  torch.device("cpu"))
    (name,) = ep.graph_signature.user_inputs
    dtype = next(n.meta["val"].dtype for n in ep.graph.nodes
                 if n.op == "placeholder" and n.name == name)

    # the call's span (utils/timing.py `span`, written with torch alone)
    profiling = torch._C._autograd._profiler_enabled

    def fn(x):
        on = profiling() and os.environ.get("TNF_SPANS") == "1"
        with (torch.profiler.record_function("tnf.serve.call") if on
              else contextlib.nullcontext()), torch.no_grad():
            return module(torch.as_tensor(x, dtype=dtype, device=device))

    fn.device = device
    return fn


def save_forward(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)
