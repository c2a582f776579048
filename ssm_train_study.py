"""Where a Mamba2-1.3B training step through the SSD kernels parts from
the plain step, and what one profiler window over that step costs.

The step is ``chip_smoke.py`` phase 9f's: Mamba2-1.3B at full width and
depth (48 layers, random weights from seed 0), 2 x 4,096 tokens of the
Zipf corpus in two micro-batches, ``accumulate_grads`` over ``model.loss``.

- Part 1, routes: the step through six routes of the differentiable scan
  (``ops.SSDScan``): both kernels; both plain versions (``ref.ssd_chunked``
  and ``ref.ssd_bwd_ref``); the plain forward with the kernel backward;
  the kernel forward with the plain backward; both plain versions in
  float64 (inputs cast up, y and h_final cast back to float32); both
  plain versions in float32 at chunk 128 (the same function summed in
  another order), a second float32 route beside the plain one.  Each
  route's loss, gradient norm and worst leaves by cosine against the
  plain float32 route and against the float64 one, and for the worst leaf
  of a stacked layer tree its worst layers.
- Part 2, calls: in the kernels' step every scan call's inputs also go
  through the plain version in float32 and in float64: the forward's y
  and h_final, and the backward's five gradients on the same inputs and
  workspaces, each as a relative Frobenius error; the largest over the
  calls, with its call; and the mean over the calls of the forward's
  error along the float64 y (a scale the kernel or plain adds).
- Part 3, the profiler: one ``make_train_step`` step in a window like
  ``chip_smoke.profile_window``'s (pads, the step, pads, a synchronise),
  host and device activity traced, then device activity alone: the host
  seconds of the window, of parsing its events, of matching launches to
  device records and of summing the device rows (``key_averages`` or a
  sum over the device records), the events, the records lost, and the
  device ms by ``chip_smoke.TRAIN_SPLIT`` group; the same two windows
  over ten calls of the SSD backward at phase 9e's Mamba2 case.

Nothing is added to the port: the routes swap the kernel wrappers that
``ops.SSDScan`` calls for the length of a step, as ``chip_smoke``'s
``plain_ssd_train`` does.

Run it on a GPU host from the repository root:

    python3 ssm_train_study.py

It prints the card's name and power limit, one line per measurement and,
as its last line, one JSON object with every number; it exits 2 without a
CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time

import chip_smoke as C

ARCH = "mamba2-1.3b"
GRADS = ("dxdt", "dda", "db", "dc", "dh0")


def frobenius(got, want) -> float:
    """|got - want| / |want| in float64 (0 where both are zero)."""
    g, w = got.double(), want.double()
    den = float(w.norm())
    return float((g - w).norm()) / den if den else float((g - w).norm())


@contextlib.contextmanager
def routed(forward=None, backward=None):
    """The scan's kernel wrappers replaced by ``forward`` and ``backward``
    (where given) for the duration."""
    from repro_torch.kernels.ssd import kernel as SK

    saved = SK.ssd, SK.ssd_bwd
    SK.ssd, SK.ssd_bwd = forward or saved[0], backward or saved[1]
    try:
        yield
    finally:
        SK.ssd, SK.ssd_bwd = saved


def plain_forward(dtype, q: int | None = None):
    """``ref.ssd_chunked`` in ``dtype`` (at chunk ``q`` where given, the
    backward then at the same), y and h_final back in float32 and the
    workspaces left in ``dtype`` for the backward (contiguous, as the
    kernel backward takes them)."""
    from repro_torch.kernels.ssd import ref as SR

    def forward(xdt, da, b, c, h0, *, chunk, workspaces=False):
        y, hf, cum, states = SR.ssd_chunked(*(t.to(dtype) for t in (xdt, da, b, c, h0)),
                                            q or chunk, workspaces=True)
        out = y.float(), hf.float()
        return (*out, cum.contiguous(), states) if workspaces else out

    return forward


def plain_backward(dtype, q: int | None = None):
    """``ref.ssd_bwd_ref`` in ``dtype`` (at chunk ``q`` where given), the
    gradients back in float32."""
    from repro_torch.kernels.ssd import ref as SR

    def backward(xdt, b, c, dy, cum, states, h_final, dh_final, *, chunk):
        up = [None if t is None else t.to(dtype) for t in (xdt, b, c, dy, dh_final, cum, states)]
        return tuple(t.float() for t in SR.ssd_bwd_ref(*up, q or chunk))

    return backward


def compare(torch, got: dict, want: dict, n_layers: int) -> dict:
    """Norms, the four worst leaves by cosine (and relative Frobenius) and,
    for the worst leaf of the stacked layer tree, its four worst layers."""
    from repro_torch.optim.grad_utils import global_norm
    from repro_torch.tree import leaves_with_paths

    def cosine(g, w):
        g, w = g.double().flatten(), w.double().flatten()
        return float(g @ w / (g.norm() * w.norm()).clamp(min=1e-300))

    rows, layered = [], {}
    for (path, g), (_, w) in zip(leaves_with_paths(got), leaves_with_paths(want)):
        if g.numel() == 0:
            continue
        name = "/".join(path)
        rows.append((cosine(g, w), name, frobenius(g, w)))
        if path[0] == "layers" and g.shape[0] == n_layers:
            layered[name] = (g, w)
    rows.sort()
    worst_layers = None
    stacked = next((name for _, name, _ in rows if name in layered), None)
    if stacked:
        g, w = layered[stacked]
        worst_layers = sorted((cosine(g[i], w[i]), i) for i in range(n_layers))[:4]
    return {"norm": float(global_norm(got)), "want_norm": float(global_norm(want)),
            "worst": rows[:4], "stacked_leaf": stacked, "worst_layers": worst_layers}


def run_routes(torch, model, params, batch, n_micro: int) -> dict:
    """Part 1: the step's loss and gradients through each route, compared."""
    from repro_torch.optim import accumulate_grads

    def step():
        with C.uncounted():
            loss, grads = accumulate_grads(model.loss, params, batch, n_micro)
        torch.cuda.synchronize()
        return float(loss), grads

    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    with routed(plain_forward(f64), plain_backward(f64)):
        loss64, g64 = step()
    with routed(plain_forward(f32), plain_backward(f32)):
        loss32, g32 = step()
    C.log(f"part 1: plain float64 loss {loss64:.9f}, plain float32 {loss32:.9f} "
          f"({time.perf_counter() - t0:.1f} s)")
    n = model.cfg.n_layers
    out = {"plain float64": {"loss": loss64},
           "plain float32": {"loss": loss32, "against float64": compare(torch, g32, g64, n)}}
    for name, fwd, bwd in (("kernels", None, None),
                           ("plain forward, kernel backward", plain_forward(f32), None),
                           ("kernel forward, plain backward", None, plain_backward(f32)),
                           ("plain float32 at chunk 128", plain_forward(f32, 128),
                            plain_backward(f32, 128))):
        with routed(fwd, bwd):
            loss, grads = step()
        out[name] = {"loss": loss, "against plain float32": compare(torch, grads, g32, n),
                     "against float64": compare(torch, grads, g64, n)}
        del grads
    for name, r in out.items():
        C.log(f"part 1 [{name}]: loss {r['loss']:.9f} (float64 {loss64:.9f}, relative "
              f"{abs(r['loss'] - loss64) / abs(loss64):.3g}); "
              + "; ".join(f"{k}: norm {v['norm']:.6f} / {v['want_norm']:.6f}, worst leaves "
                          f"{[(round(c, 6), p, float(f'{e:.3g}')) for c, p, e in v['worst']]}, "
                          f"{v['stacked_leaf']}'s worst layers "
                          f"{[(round(c, 6), i) for c, i in v['worst_layers'] or []]}"
                          for k, v in r.items() if k != "loss"))
    return out


def run_calls(torch, model, params, batch, n_micro: int) -> dict:
    """Part 2: each scan call of the kernels' step against the plain
    version in float32 and float64 on the same inputs."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as SR
    from repro_torch.optim import accumulate_grads

    kf, kb = SK.ssd, SK.ssd_bwd
    f64 = torch.float64
    fwd_rows, bwd_rows = [], []

    def bias(got, want):
        # the error's share along the float64 y: a scale the route adds
        return float(((got.double() - want) * want).sum() / (want * want).sum())

    def bf16_valued(t):
        return bool(torch.equal(t, t.bfloat16().float()))

    def forward(xdt, da, b, c, h0, *, chunk, workspaces=False):
        out = kf(xdt, da, b, c, h0, chunk=chunk, workspaces=workspaces)
        y32, hf32 = SR.ssd_chunked(xdt, da, b, c, h0, chunk)
        y64, hf64 = SR.ssd_chunked(*(t.to(f64) for t in (xdt, da, b, c, h0)), chunk)
        fwd_rows.append({"y": frobenius(out[0], y32), "h_final": frobenius(out[1], hf32),
                         "y_f64": frobenius(out[0], y64), "plain_y_f64": frobenius(y32, y64),
                         "y_bias": bias(out[0], y64), "plain_y_bias": bias(y32, y64),
                         "bc_bf16": bf16_valued(b) and bf16_valued(c),
                         "da_min": float(da.min())})
        return out

    def backward(xdt, b, c, dy, cum, states, h_final, dh_final, *, chunk):
        out = kb(xdt, b, c, dy, cum, states, h_final, dh_final, chunk=chunk)
        want = SR.ssd_bwd_ref(xdt, b, c, dy, dh_final, cum, states, chunk)
        up = [None if t is None else t.to(f64) for t in (xdt, b, c, dy, dh_final, cum, states)]
        exact = SR.ssd_bwd_ref(*up, chunk)
        row = {"cum_min": float(cum.min()), "dy_max": float(dy.abs().max())}
        for k, o, w, e in zip(GRADS, out, want, exact):
            if k == "dh0":
                continue  # h0 is zero and takes no gradient in training
            row[k] = frobenius(o, w)
            row[k + "_f64"] = frobenius(o, e)
            row["plain_" + k + "_f64"] = frobenius(w, e)
        bwd_rows.append(row)
        return out

    with C.uncounted(), routed(forward, backward):
        accumulate_grads(model.loss, params, batch, n_micro)
    torch.cuda.synchronize()
    n = model.cfg.n_layers

    def worst(rows, key):
        i = max(range(len(rows)), key=lambda j: rows[j][key])
        return {"max": rows[i][key], "call": i}

    fwd = {k: worst(fwd_rows, k) for k in ("y", "h_final", "y_f64", "plain_y_f64")}
    bwd = {k: worst(bwd_rows, k) for k in bwd_rows[0] if k not in ("cum_min", "dy_max")}
    # the backward runs the layers last to first in each micro-batch
    for v in bwd.values():
        v["layer"] = n - 1 - v["call"] % n
    summary = {"forward_calls": len(fwd_rows), "backward_calls": len(bwd_rows),
               "bc_bf16_calls": sum(r["bc_bf16"] for r in fwd_rows),
               "da_min": min(r["da_min"] for r in fwd_rows),
               "cum_min": min(r["cum_min"] for r in bwd_rows),
               "forward": fwd, "backward": bwd,
               "y_bias_mean": sum(r["y_bias"] for r in fwd_rows) / len(fwd_rows),
               "plain_y_bias_mean": sum(r["plain_y_bias"] for r in fwd_rows) / len(fwd_rows),
               "backward_by_layer": bwd_rows[:n]}
    fwd_max = {k: (float(f"{v['max']:.3g}"), v["call"]) for k, v in fwd.items()}
    bwd_max = {k: (float(f"{v['max']:.3g}"), v["layer"]) for k, v in bwd.items()}
    C.log(f"part 2: {len(fwd_rows)} forward calls ({summary['bc_bf16_calls']} with b and c "
          f"bf16-valued; da down to {summary['da_min']:.4g}), {len(bwd_rows)} backward calls "
          f"(cum down to {summary['cum_min']:.4g}); the kernel against plain float32 and "
          f"float64, and plain float32 against float64, the largest relative Frobenius over "
          f"the calls (with its call): forward {fwd_max}; backward (with its layer) {bwd_max}; "
          f"the forward's scale error along float64's y, mean over the calls: kernel "
          f"{summary['y_bias_mean']:.3g}, plain {summary['plain_y_bias_mean']:.3g}")
    return summary


def traced_window(torch, run, cpu: bool, pad: int = C.REPEATABLE_PAD) -> dict:
    """Part 3: one window around ``run()`` (``chip_smoke.profile_window``'s
    pads and launch matching), its host seconds by stage, with or without
    host activity traced."""
    from torch.profiler import ProfilerActivity, profile

    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1)
        run()
        for _ in range(pad // 2):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    events = prof.events()
    t2 = time.perf_counter()
    launches = sorted((e for e in events if e.device_type == cpu_t and "LaunchKernel" in e.name),
                      key=lambda e: e.time_range.start)
    recorded = {e.id for e in events if e.device_type == cuda_t}
    lost = [i for i, e in enumerate(launches) if e.id not in recorded]
    fault = C.window_fault(len(launches), lost, pad)
    t3 = time.perf_counter()
    by_name: dict = {}
    for e in events:
        if e.device_type == cuda_t and "spin_kernel" not in e.name:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    t4 = time.perf_counter()
    out = {"cpu": cpu, "events": len(events), "launches": len(launches), "lost": len(lost),
           "fault": fault, "window_s": t1 - t0, "parse_s": t2 - t1, "match_s": t3 - t2,
           "sum_s": t4 - t3, "device_ms": sum(by_name.values()) / 1e3, "kernels": len(by_name),
           "split": split(by_name)}
    if cpu:
        rows = [e for e in prof.key_averages()
                if e.device_type == cuda_t and "spin_kernel" not in e.key]
        out["key_averages_s"] = time.perf_counter() - t4
        out["key_averages_device_ms"] = sum(e.self_device_time_total for e in rows) / 1e3
    return out


def split(by_name: dict) -> dict:
    """Device ms by ``chip_smoke.TRAIN_SPLIT`` group (``device_split``'s
    grouping over a name -> microseconds map)."""
    out = dict.fromkeys([name for name, _ in C.TRAIN_SPLIT] + ["other"], 0.0)
    for key, us in by_name.items():
        k = key.lower()
        out[next((n for n, frags in C.TRAIN_SPLIT if any(f in k for f in frags)), "other")] += us
    return {k: round(v / 1e3, 3) for k, v in out.items()}


def run_profiler(torch, dev, model, params, batch, n_micro: int) -> dict:
    """Part 3: the step's windows, then ten SSD backward calls'."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    step = make_train_step(model, AdamWConfig(lr=C.SSM_TRAIN_LR, warmup_steps=1,
                                              total_steps=C.SSM_TRAIN_STEPS), n_micro)
    state = adamw_init(params)
    out = {}
    with C.uncounted():
        step(params, state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, batch)
        torch.cuda.synchronize()
        out["step_host_s"] = time.perf_counter() - t0
        for cpu in (True, False):
            out[f"step, {'host and device' if cpu else 'device'} traced"] = traced_window(
                torch, lambda: step(params, state, batch), cpu)
        del step, state
        torch.cuda.empty_cache()
        name, shape, nonzero = C.SSD_BWD_CASES[0]
        xdt, da, b, c, h0, dy, dhf = C.ssd_bwd_case(torch, dev, shape, nonzero)
        _, hf, cum, states = SK.ssd(xdt, da, b, c, h0, chunk=256, workspaces=True)

        def calls():
            for _ in range(10):
                SK.ssd_bwd(xdt, b, c, dy, cum, states, hf, dhf, chunk=256)

        calls()
        for cpu in (True, False):
            out[f"ten {name} backward calls, {'host and device' if cpu else 'device'} "
                f"traced"] = traced_window(torch, calls, cpu)
    C.log(f"part 3: one training step {out.pop('step_host_s'):.3f} s untraced; windows "
          + "; ".join(f"{k}: {json.dumps(v)}" for k, v in out.items()))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_train_study: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(C.ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ShardedLoader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    C.log(C.nvidia_smi_line())
    C.build_kernels()
    dev = torch.device("cuda")
    model, params = C.family_model(torch, dev, ARCH)
    cfg = model.cfg
    corpus = C.train_corpus(get_config("smollm-135m").vocab)
    loader = ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=C.SSM_TRAIN_L,
                                      global_batch=C.SSM_TRAIN_B), corpus=corpus)
    batch = C._to(loader.batch_at(0), dev)
    n_micro = C.SSM_TRAIN_MICRO
    result = {"routes": run_routes(torch, model, params, batch, n_micro)}
    torch.cuda.empty_cache()
    result["calls"] = run_calls(torch, model, params, batch, n_micro)
    torch.cuda.empty_cache()
    result["profiler"] = run_profiler(torch, dev, model, params, batch, n_micro)
    C.log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
