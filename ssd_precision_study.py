"""How close a TF32 or a bf16 form of the SSD scan stays to float32 on the card.

Two forms of the port's plain SSD version (``repro_torch.kernels.ssd.ref``)
are held against the plain float32 version, which runs with
``torch.backends.cuda.matmul.allow_tf32 = False`` (set here, and the
default):

- ``tf32``: ``allow_tf32 = True``, so its einsums run as single TF32
  products on the tensor cores;
- ``bf16``: every einsum operand rounded to bf16 (the products of the
  rounded values and their sums then in float32).

The SSD kernel is measured beside them.  Each error is max |form - float32|
over max |float32|, for y and for h_final: the measure that the kernel's
check ``SSD_REL_TOL`` (1e-4) bounds.  Inputs:

- (a) ``chip_smoke.ssd_case``'s draw at the Mamba2-1.3B prefill shape (B 4,
  L 1024, H 64, P 64, N 128, G 1) and at the Zamba2-7B one (B 2, L 4096,
  H 112, P 64, N 64, G 2);
- (b) every layer's scan inputs in the full-width Mamba2-1.3B prefill of
  ``chip_smoke.py`` phase 5 (random weights from seed 0, 4 prompts of 1024
  tokens), captured by routing ``models.ssm.ssd_scan`` through a recorder
  in this script; nothing is added to the port.

Run it on a GPU host from the repository root:

    python3 ssd_precision_study.py

It prints the card's name and power limit, one line per case and, as its
last line, one JSON object with every number; it exits 2 without a CUDA
device.
"""

from __future__ import annotations

import contextlib
import json
import sys

import chip_smoke as C

FORMS = ("tf32", "bf16", "kernel")


@contextlib.contextmanager
def form(torch, name: str):
    """The plain version's einsums in ``name``'s form: "tf32" allows TF32
    products, "bf16" rounds every einsum operand to bf16, "f32" neither."""
    saved = torch.einsum
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    if name == "bf16":
        torch.einsum = lambda eq, *ops: saved(eq, *(o.to(torch.bfloat16).float() for o in ops))
    try:
        yield
    finally:
        torch.einsum = saved
        torch.backends.cuda.matmul.allow_tf32 = False


def errors(torch, case: tuple, chunk: int) -> dict:
    """{form: (rel err of y, rel err of h_final)} of each form against the
    plain float32 version on ``case`` (xdt, da, b, c, h0)."""
    from repro_torch.kernels.ssd import ops as SO
    from repro_torch.kernels.ssd import ref as SR

    with form(torch, "f32"):
        y, hf = SR.ssd_ref(*case, chunk=chunk)
    out = {}
    for name in FORMS:
        if name == "kernel":
            y_f, h_f = SO.ssd(*case, chunk=chunk)
        else:
            with form(torch, name):
                y_f, h_f = SR.ssd_ref(*case, chunk=chunk)
        out[name] = (float((y_f - y).abs().max() / y.abs().max()),
                     float((h_f - hf).abs().max() / hf.abs().max()))
    torch.cuda.synchronize()
    return out


def model_layers(torch, dev) -> list:
    """The errors of every layer's scan in one full-width Mamba2-1.3B
    prefill (phase 5's model and prompts); the prefill itself continues
    from the kernel's outputs, as it does in phase 5."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch import make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models import ssm as TS

    cfg = get_config("mamba2-1.3b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (C.SSM_B, C.SSM_L)).astype(np.int32)).to(dev)
    layers = []
    scan = TS.ssd_scan

    def recorder(xdt, da, b, c, h0=None, chunk=256):
        h0_ = h0 if h0 is not None else torch.zeros(
            (xdt.shape[0], xdt.shape[2], b.shape[-1], xdt.shape[-1]), device=dev)
        layers.append(errors(torch, (xdt, da, b, c, h0_), chunk))
        return scan(xdt, da, b, c, h0=h0, chunk=chunk)

    TS.ssd_scan = recorder
    try:
        make_prefill_step(model)(params, {"tokens": prompts})
    finally:
        TS.ssd_scan = scan
    torch.cuda.synchronize()
    if len(layers) != cfg.n_layers:
        raise AssertionError(f"recorded {len(layers)} scans, expected {cfg.n_layers}")
    return layers


def worst(rows: list) -> dict:
    return {name: [max(r[name][0] for r in rows), max(r[name][1] for r in rows)]
            for name in FORMS}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_precision_study: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(C.ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.nvidia_smi_line()
    C.log(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cases = {}
    for name, shape in (("mamba2_draw", C.SSD_MAMBA), ("zamba2_draw", C.SSD_ZAMBA)):
        cases[name] = errors(torch, C.ssd_case(torch, dev, gen, shape), 256)
        torch.cuda.empty_cache()
    layers = model_layers(torch, dev)
    cases["mamba2_prefill_layers"] = worst(layers)
    for name, errs in cases.items():
        C.log(f"{name}: " + "; ".join(
            f"{f} y {e[0]:.3g} h_final {e[1]:.3g}" for f, e in errs.items()))
    per_layer = {f: sorted(max(r[f]) for r in layers) for f in FORMS}
    C.log("mamba2 prefill, per layer (max of y and h_final), median / max: " + "; ".join(
        f"{f} {v[len(v) // 2]:.3g} / {v[-1]:.3g}" for f, v in per_layer.items()))
    within = {f: all(max(e[f]) <= C.SSD_REL_TOL for e in [*cases.values()]) for f in FORMS}
    C.log(f"within SSD_REL_TOL = {C.SSD_REL_TOL} in every case: {within}")
    C.log(json.dumps({"card": card, "tolerance": C.SSD_REL_TOL, "cases": cases,
                      "per_layer_median": {f: v[len(v) // 2] for f, v in per_layer.items()},
                      "within_tolerance": within}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
