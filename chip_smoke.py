#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (veles_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Print the card's name and power limit (nvidia-smi); fail without CUDA.
2. Build the port's CUDA kernels from veles_tpu_torch/csrc/ (nvcc, one
   process per source, all at once) and print the build seconds.
3. For K2 (LRN forward) and K4 (fused LRN -> max pool forward), at both
   AlexNet shapes at batch 64 in f32: hold the kernel against its plain
   PyTorch version on the same inputs (|kernel - plain| <= 1e-6 +
   1e-5*|plain|: the same f32 arithmetic in the same order, so only the
   rsqrt approximation differs), and time the kernel, the plain version,
   and for K2 the one PyTorch call computing the same function
   (F.local_response_norm, checked first to agree), each launch with a
   cold L2 cache, beside the least time the card could take.
4. Serve the full-width AlexNet (227x227x3, fc 4096, 1000 classes, ring of
   64) through the same function the CLI uses, under lrn_maxpool=fused
   and again under composed, with one seed. POST 1, 8 and 64 rows over
   loopback HTTP; check 200, shapes (rows, 1000), finite softmax rows
   summing to 1, the same classes under both settings, and the served
   outputs against the plain forward on the card (max abs 1e-5: only the
   LRN's rsqrt rounding differs, carried linearly to probabilities of
   ~1e-3). Launch counters are zeroed just before each setting's requests
   and read just after: K4 must have launched under fused, K2 under
   composed.
5. Print one {"kernels": [...]} line, then the card line and the closing
   {"ok": true, "device": {...}} line.

The script leaves PyTorch's TF32 defaults as they are: the server's
forward turns TF32 off for itself (the port serves f32), and the plain
forward and the per-step times here run under the same
`backends.full_f32`. Any failure raises before the last line, and the exit
code is then not 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
ALEXNET = os.path.join(REPO, "veles_tpu_torch", "samples", "alexnet.py")
B = 64                  # the ring, and the kernels' batch
HW, N_CLASSES = 227, 1000
#: extra CLI arguments of the served model (none: the full-width AlexNet)
SERVE_ARGS: list = []
K, ALPHA, BETA, N = 2.0, 1e-4, 0.75, 5
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6
SERVE_ATOL = 1e-5
#: (name substring, HBM bytes/s, f32 non-tensor FLOP/s) — data-sheet peaks
CARDS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))


def card_peaks(name: str):
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops, key
    print(f"chip_smoke: no peak table for {name!r}; bounds use the H100 "
          f"SXM's", flush=True)
    return 3.35e12, 67e12, "H100 (assumed)"


class ColdTimer:
    """Median device time of one call, each launch preceded by a write of
    a buffer twice the 50 MB L2, so no input is left in L2 by the last
    repetition."""

    def __init__(self, device, reps: int = 25) -> None:
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)
        self.reps = reps

    def __call__(self, fn) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def lrn_ops(numel: int) -> int:
    """f32 operations one LRN output needs: n squares, n-1 adds, the
    scale (k + alpha*sum: 2), sqrt, rsqrt, two products for s^(-3/4) and
    the final product: 2n + 6."""
    return numel * (2 * N + 6)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol: float) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond atol {atol} + rtol "
            f"{rtol}; max abs err {float(diff.max()):.3e}")
    return float(diff.max())


def kernel_phase(kernels, dev, bw, flops):
    """Hold K2 and K4 against their plain versions and time them."""
    timer = ColdTimer(dev)
    rs = np.random.RandomState(0)
    rows = {"lrn_forward": [], "lrn_maxpool_forward": []}
    for layer, shape in (("L1", (B, 55, 55, 96)), ("L2", (B, 27, 27, 256))):
        # post-ReLU activations: half the inputs are zeros, so pooling
        # windows tie as they do on the served path
        x = torch.from_numpy(np.maximum(rs.randn(*shape), 0)
                             .astype(np.float32)).to(dev)
        nbytes = x.numel() * 4
        with torch.inference_mode():
            # -- K2 --------------------------------------------------------
            yk = kernels.lrn_forward(x, K, ALPHA, BETA, N)
            yp = kernels.lrn_forward_plain(x, K, ALPHA, BETA, N)
            torch.cuda.synchronize()
            err = check_close(f"lrn_forward {layer}", yk, yp, KERNEL_RTOL,
                              KERNEL_ATOL)

            def lib():
                return F.local_response_norm(x.permute(0, 3, 1, 2), size=N,
                                             alpha=ALPHA * N, beta=BETA,
                                             k=K)
            check_close(f"F.local_response_norm {layer}",
                        lib().permute(0, 2, 3, 1), yp, 1e-4, 1e-5)
            bound = max(2 * nbytes / bw, lrn_ops(x.numel()) / flops) * 1e3
            rows["lrn_forward"].append({
                "shape": list(shape), "max_abs_err": err,
                "ms": timer(lambda: kernels.lrn_forward(x, K, ALPHA, BETA,
                                                        N)),
                "plain_ms": timer(lambda: kernels.lrn_forward_plain(
                    x, K, ALPHA, BETA, N)),
                "library_ms": timer(lib), "bound_ms": bound,
                "bound_by": ("bytes" if 2 * nbytes / bw
                             >= lrn_ops(x.numel()) / flops
                             else "operations")})
            # -- K4 --------------------------------------------------------
            zk = kernels.lrn_maxpool_forward(x, K, ALPHA, BETA, N)
            zp = kernels.lrn_maxpool_forward_plain(x, K, ALPHA, BETA, N)
            torch.cuda.synchronize()
            err = check_close(f"lrn_maxpool_forward {layer}", zk, zp,
                              KERNEL_RTOL, KERNEL_ATOL)
            t_bytes = (nbytes + zk.numel() * 4) / bw
            t_ops = (lrn_ops(x.numel()) + zk.numel() * 8) / flops
            rows["lrn_maxpool_forward"].append({
                "shape": list(shape), "out_shape": list(zk.shape),
                "max_abs_err": err,
                "ms": timer(lambda: kernels.lrn_maxpool_forward(
                    x, K, ALPHA, BETA, N)),
                "plain_ms": timer(lambda: kernels.lrn_maxpool_forward_plain(
                    x, K, ALPHA, BETA, N)),
                "library_ms": None, "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        for name in rows:
            r = rows[name][-1]
            print(f"KERNEL {name} {layer} {r['shape']}: ms "
                  f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                  f"{r['library_ms']} bound_ms {r['bound_ms']:.4f} "
                  f"({r['bound_by']}) max_abs_err {r['max_abs_err']:.3e}",
                  flush=True)
        del x, yk, yp, zk, zp
    return rows


def tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def post(url: str, x: np.ndarray):
    body = json.dumps({"inputs": x.tolist()}).encode()
    req = urllib.request.Request(url + "/predict", data=body, method="POST")
    req.add_header("Content-Type", "application/json")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, resp = r.status, json.loads(r.read())
    return status, resp, time.perf_counter() - t0


def get(url: str, path: str):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, json.loads(r.read())


def plain_forward(srv, kernels, x: np.ndarray) -> np.ndarray:
    """The served model on the card in full f32 with every LRN through its
    plain version and no fused pair: the reference the served outputs are
    held against. Rows are padded into the same 64-row ring the server
    runs."""
    from veles_tpu_torch.backends import full_f32
    ring = np.zeros((srv.ring_slots,) + x.shape[1:], np.float32)
    ring[:len(x)] = x
    h = torch.from_numpy(ring).to(srv.device)
    with torch.inference_mode(), full_f32(srv.device):
        for u, p in zip(srv._fwd.forwards, srv._fwd.params()):
            if getattr(u, "variant_op", None) == "lrn":
                h = kernels.lrn_forward_plain(h, u.k, u.alpha, u.beta, u.n)
            else:
                h = u.fused_apply(p, h, train=False)
        return torch.softmax(h, dim=-1)[:len(x)].cpu().numpy()


def layer_times(srv, x: np.ndarray) -> list:
    """Device ms of each step of the served forward on one ring (mean of
    10 after a warm-up), with the unit names of the plan."""
    from veles_tpu_torch.backends import full_f32
    fwd = srv._fwd
    h0 = torch.from_numpy(x).to(srv.device)
    out = []
    with torch.inference_mode(), full_f32(srv.device):
        for _ in range(2):
            fwd._forward(fwd.params(), h0)
        torch.cuda.synchronize()
        h = h0
        for i, (kind, j, v) in enumerate(fwd._plan):
            if kind == "skip":
                continue
            u = fwd.forwards[i]

            def step(h=h, u=u, kind=kind, j=j, v=v, i=i):
                if kind == "pair":
                    return fwd._apply_fused_pair(v, u, fwd.forwards[j], h)
                if v is not None:
                    return u.fused_apply(fwd.params()[i], h, variant=v)
                return u.fused_apply(fwd.params()[i], h)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            step()
            start.record()
            for _ in range(10):
                nxt = step()
            end.record()
            end.synchronize()
            name = type(u).__name__ + (
                "+" + type(fwd.forwards[j]).__name__ if kind == "pair"
                else "")
            out.append((name, start.elapsed_time(end) / 10))
            h = nxt
    return out


def serve_phase(launcher, kernels, dev):
    """Serve the full-width AlexNet under both lrn_maxpool settings."""
    rs = np.random.RandomState(1)
    # float64 rounded to 3 decimals: short JSON numbers (a 64-row request
    # is ~80 MB of JSON); the server reads them as the float32 values
    # plain_forward gets
    requests = [rs.randn(rows, HW, HW, 3).round(3)
                for rows in sorted({1, min(8, B), B})]
    served, launches = {}, {name: 0 for name in kernels.KERNELS}
    # what the CLI runs under: PyTorch's defaults, which let cuDNN use TF32
    tf32_default = tf32_flags()
    print(f"SERVE: process TF32 flags (cudnn, matmul) {tf32_default}",
          flush=True)
    for setting in ("fused", "composed"):
        t0 = time.perf_counter()
        srv = launcher.serve([ALEXNET, "--serve", "0", "-r", "1234",
                              "--lrn-maxpool", setting, "--serve-ring",
                              str(B), "--serve-max-body", str(1 << 30),
                              *SERVE_ARGS])
        try:
            if srv.device != dev:
                raise AssertionError(f"served on {srv.device}, not {dev}")
            print(f"SERVE {setting}: server up in "
                  f"{time.perf_counter() - t0:.2f} s on {srv.device}, "
                  f"variants {srv._fwd.variant_table()}", flush=True)
            url = f"http://127.0.0.1:{srv.port}"
            # -- the main path: counts zeroed just before, read just after
            kernels.reset_launch_counts()
            outs = []
            for x in requests:
                status, resp, dt = post(url, x)
                if status != 200:
                    raise AssertionError(f"/predict answered {status}")
                out = np.asarray(resp["outputs"], np.float64)
                outs.append((out, resp["classes"]))
                print(f"SERVE {setting}: {len(x)} rows -> 200 in "
                      f"{dt * 1e3:.1f} ms (JSON both ways included)",
                      flush=True)
            counts = kernels.launch_counts()
            print(f"SERVE {setting}: launches {counts}", flush=True)
            if tf32_flags() != tf32_default:
                raise AssertionError(f"serving changed the process's TF32 "
                                     f"flags: {tf32_default} -> "
                                     f"{tf32_flags()}")
            for name, c in counts.items():
                launches[name] += c
            want = {"fused": "lrn_maxpool_forward",
                    "composed": "lrn_forward"}[setting]
            if counts[want] <= 0:
                raise AssertionError(f"{want} never launched under "
                                     f"lrn_maxpool={setting}")
            # -- checks off the main path
            for x, (out, classes) in zip(requests, outs):
                if out.shape != (len(x), N_CLASSES):
                    raise AssertionError(f"outputs shaped {out.shape}")
                if not np.isfinite(out).all():
                    raise AssertionError("non-finite outputs")
                if np.abs(out.sum(axis=1) - 1).max() > 1e-4:
                    raise AssertionError("softmax rows do not sum to 1")
                if classes != out.argmax(axis=1).tolist():
                    raise AssertionError("classes are not the argmax")
                ref = plain_forward(srv, kernels, x.astype(np.float32))
                err = float(np.abs(out - ref).max())
                if err > SERVE_ATOL:
                    raise AssertionError(
                        f"served vs plain forward: max abs err {err:.3e} "
                        f"> {SERVE_ATOL}")
                print(f"SERVE {setting}: {len(x)} rows vs plain forward "
                      f"max abs err {err:.3e}", flush=True)
            served[setting] = [c for _, c in outs]
            for path in ("/healthz", "/info"):
                status, _ = get(url, path)
                if status != 200:
                    raise AssertionError(f"{path} answered {status}")
            ring = rs.randn(B, HW, HW, 3).astype(np.float32)
            steps = layer_times(srv, ring)
            total = sum(ms for _, ms in steps)
            print(f"FORWARD {setting}: ring of {B} in {total:.3f} ms "
                  f"(sum of steps): " + ", ".join(
                      f"{n} {ms:.3f}" for n, ms in steps), flush=True)
        finally:
            srv.stop()
        del srv
        torch.cuda.empty_cache()
    if served["fused"] != served["composed"]:
        raise AssertionError("fused and composed served different classes")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script runs on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from veles_tpu_torch import launcher
    from veles_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    bw, flops, table = card_peaks(torch.cuda.get_device_name(0))
    print(f"peaks ({table}): {bw / 1e12} TB/s, {flops / 1e12} f32 TFLOP/s; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    libs = kernels.build()
    print(f"BUILD {len(libs)} kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rows = kernel_phase(kernels, dev, bw, flops)
    launches = serve_phase(launcher, kernels, dev)

    meta = {"lrn_forward": ("veles_tpu_torch/csrc/lrn_forward.cu",
                            "veles_tpu/ops/pallas_kernels.py:164"),
            "lrn_maxpool_forward": (
                "veles_tpu_torch/csrc/lrn_maxpool_forward.cu",
                "veles_tpu/ops/pallas_kernels.py:349")}
    entries = []
    for name, per_shape in rows.items():
        lib = [r["library_ms"] for r in per_shape]
        entries.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in per_shape),
            # one served batch runs each kernel once per AlexNet shape:
            # the times below are the sums over the two shapes
            "ms": sum(r["ms"] for r in per_shape),
            "plain_ms": sum(r["plain_ms"] for r in per_shape),
            "bound_ms": sum(r["bound_ms"] for r in per_shape),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                        for r in per_shape)
                         else "operations"),
            "library_ms": None if None in lib else sum(lib),
            "shapes": per_shape})
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
