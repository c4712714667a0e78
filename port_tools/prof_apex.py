"""The CLR apex regressor's convolutions timed on the card, layer by layer.

    python port_tools/prof_apex.py [--root DIR] [--reps 5] [--out FILE]

Imports ``vwfd_tpu_torch`` from ``--root`` (default: this checkout) and
builds ``nets/fbcnn.py::QFPredictor`` at ``configs/clr.yaml``'s widths (nc
(16, 24, 32, 48), nb 1, 4 outputs, float32, random weights from a seed). At
the copies CLR's train step gives it, (48, 256, 256, 3) at b8 k 6 and
(18, 512, 512, 3) at b3 k 6, with cuDNN's heuristic choice (the port's
setting) and with ``cudnn.benchmark`` on, inside ``device.full_f32`` as the
step runs it, it measures:

- the regressor's forward + backward (the gradients into the copies and
  the parameters of an L1 loss on both heads), warm ms (CUDA events);
- each convolution alone at its shape in that pass (the Bayar 5×5 on the
  symm-padded copies and every ``nn.Conv2d``, found by forward hooks):
  forward + backward warm ms, and its device kernels under
  ``torch.profiler`` (ms per pass, the three longest by name).

Prints one JSON line per shape and setting (and appends it to ``--out``)
with the card's name and power limit. Needs one CUDA card. A measurement
tool, not part of the package: nothing imports it.
"""

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

SHAPES = [(48, 256, 256, 3), (18, 512, 512, 3)]


def time_ms(fn, iters, warmup=2):
    """Mean device ms of one call: events around ``iters`` calls queued
    behind a device sleep."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def layers(net, x):
    """``[(name, input shape, weight, bias, stride, padding)]`` of every
    convolution in one forward of ``net`` on ``x``: the Bayar conv (on the
    symm-padded copies), then the modules'."""
    from vwfd_tpu_torch.ops.filters import bayar_constrain
    n, h, w, c = x.shape
    bk = bayar_constrain(net.bayar_kernel).permute(3, 2, 0, 1).detach()
    out = [("bayar", (n, c, h + 4, w + 4), bk, None, 1, 0)]
    hooks = []
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(
                lambda m, i, o, name=name: out.append(
                    (name, tuple(i[0].shape), m.weight.detach(),
                     None if m.bias is None else m.bias.detach(),
                     m.stride[0], m.padding[0]))))
    with torch.no_grad():
        net(x)
    for hook in hooks:
        hook.remove()
    return out


def conv_pass(shape, weight, bias, stride, pad, g):
    """Forward + backward of one convolution (gradients into its input,
    weight and bias) with a normal cotangent."""
    x = torch.randn(shape, device=weight.device,
                    generator=g).requires_grad_()
    w = weight.clone().requires_grad_()
    b = None if bias is None else bias.clone().requires_grad_()
    y = F.conv2d(x, w, b, stride=stride, padding=pad)
    cot = torch.randn(y.shape, device=weight.device, generator=g)
    ins = [t for t in (x, w, b) if t is not None]

    def run():
        out = F.conv2d(x, w, b, stride=stride, padding=pad)
        return torch.autograd.grad(out, ins, cot)
    return run


def kernels_of(fn, reps):
    """Device kernels of ``fn`` by name, ms per call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name[:90]] += e.time_range.elapsed_us() / 1e3 / reps
    return ms


def measure(shape, benchmark, reps):
    from vwfd_tpu_torch.device import full_f32
    from vwfd_tpu_torch.nets.fbcnn import QFPredictor
    from vwfd_tpu_torch.metrics import l1_loss
    gen = torch.Generator().manual_seed(0)
    net = QFPredictor(nc=(16, 24, 32, 48), nb=1, classes=4, crop_pred=True,
                      out_size=shape[1])
    net.init_params(gen)
    net = net.cuda()
    g = torch.Generator("cuda").manual_seed(5)
    x = torch.rand(shape, device="cuda", generator=g).requires_grad_()
    gt = (torch.rand(shape[:3] + (1,), device="cuda", generator=g)
          > 0.5).float()
    target = torch.rand((shape[0], 4), device="cuda", generator=g)
    params = list(net.parameters())

    def step():
        mask, pred = net(x)
        loss = l1_loss(pred, target) + l1_loss(mask, gt)
        return torch.autograd.grad(loss, [x] + params)

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=benchmark,
                     deterministic=cudnn.deterministic), full_f32():
        whole = time_ms(step, reps)
        rows = []
        for name, in_shape, w, b, stride, pad in layers(net, x.detach()):
            run = conv_pass(in_shape, w, b, stride, pad, g)
            ms = time_ms(run, reps)
            top = kernels_of(run, reps).most_common(3)
            rows.append({"layer": name, "input_nchw": list(in_shape),
                         "weight": list(w.shape), "stride": stride,
                         "fwd_bwd_ms": ms,
                         "top_kernels_ms": {k: v for k, v in top}})
    rows.sort(key=lambda r: -r["fwd_bwd_ms"])
    return {"tool": "prof_apex", "shape": list(shape),
            "cudnn_benchmark": benchmark, "regressor_fwd_bwd_ms": whole,
            "convs_fwd_bwd_ms_sum": sum(r["fwd_bwd_ms"] for r in rows),
            "convs": rows, "card": card()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("prof_apex needs a CUDA card")
    sys.path.insert(0, args.root)
    for shape in SHAPES:
        for benchmark in (False, True):
            line = json.dumps(measure(shape, benchmark, args.reps))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
