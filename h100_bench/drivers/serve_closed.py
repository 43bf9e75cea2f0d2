"""Window driver ``serve_closed``: one caller in a closed loop, one photo per
call, through the port's ``make_denoise_fn`` and ``infer.full.denoise_image``
(numpy in, numpy out), timed from the call to its numpy result.

The traffic file fixes a cycle of request shapes (each ``[H, W, count]``);
every seed sends the same cycle, in an order of its own, so every seed does
the same work. Set-up makes the weights (one draw on the device from the
seed, He-normal weights and small biases, in the served type, float32),
``pool`` noisy images per cycle slot at sigma drawn uniform in the
traffic's range, and warms every shape. After the window the harness
compares a sample of the answers, drawn from the seed and holding every
shape, with the reference's.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from h100_bench import check, corpus
from h100_bench import trace as tr
from h100_bench.drivers.trainer import Phases
from h100_bench.reference import model as ref


def make_weights(cfg_fields: Dict, seed: int, device) -> Dict:
    """{layer: {"w", "b"}} float32 on ``device``: one normal draw from a
    generator on the device, split into He-normal weights and biases of
    standard deviation 0.02."""
    m = cfg_fields["model"]
    blind = cfg_fields["noise"]["value"] == "blind"
    shapes = ref.layer_shapes(3, ref.n_outputs(3, blind), m["enc_features"],
                              m["dec_features"], m["nin_a_features"],
                              m["nin_b_features"])
    sizes = [math.prod(s) + s[0] for s in shapes.values()]
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2 ** 63)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    params, o = {}, 0
    for (name, (co, ci, kh, kw)), n in zip(shapes.items(), sizes):
        w = flat[o:o + n - co].view(co, ci, kh, kw) * math.sqrt(
            2.0 / (kh * kw * ci))
        params[name] = {"w": w.contiguous(), "b": flat[o + n - co:o + n] * 0.02}
        o += n
    return params


def request_plan(traffic: Dict, seed: int, n: int) -> List[int]:
    """Slot index of each of the first ``n`` requests: the cycle of slots,
    shuffled anew each cycle from the seed."""
    cycle = [i for i, (_, _, k) in enumerate(traffic["shapes"])
             for _ in range(k)]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    out = []
    while len(out) < n:
        out.extend(rng.permutation(cycle).tolist())
    return out[:n]


def sample_plan(traffic: Dict, seed: int, plan: List[int]) -> set:
    """The requests whose answers are compared: for every slot of the
    cycle one of its requests among the first ``sample_from``, and more
    drawn from those, ``sample`` in all; all from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    head = plan[:traffic["sample_from"]]
    picks = {int(rng.choice([j for j, s in enumerate(head) if s == slot]))
             for slot in sorted(set(head))}
    rest = [j for j in range(len(head)) if j not in picks]
    extra = traffic["sample"] - len(picks)
    picks |= set(rng.choice(rest, max(extra, 0), replace=False).tolist())
    return picks


def inputs(traffic: Dict, fields: Dict, seed: int, device):
    """(weights, noisy images): ``pool`` images per slot of the cycle,
    slot-major, each with its sigma."""
    params = make_weights(fields, seed, device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    lo, hi = traffic["sigma_255"]
    n = len(traffic["shapes"]) * traffic["pool"]
    images = corpus.photos(
        seed, [(h, w) for h, w, _ in traffic["shapes"]
               for _ in range(traffic["pool"])], rng.uniform(lo, hi, n), device)
    return params, images


def run(cell, ctx: Dict) -> Dict:
    from ssdn_tpu_torch.config import train_config_from_json
    from ssdn_tpu_torch.infer.full import denoise_image, make_denoise_fn

    traffic, seed, dev = cell.traffic, ctx["seed"], torch.device(ctx["device"])
    fields = dict(cell.config["train_config"], seed=seed)
    cfg = train_config_from_json(json.dumps(fields))
    phases = Phases(ctx["start_wall"])
    params, images = inputs(traffic, fields, seed, dev)
    phases("weights and images")
    shapes, pool = traffic["shapes"], traffic["pool"]
    fn = make_denoise_fn(cfg, device=dev)
    plan = request_plan(traffic, seed, traffic["max_requests"])
    seen = [0] * len(shapes)

    def request(i):
        slot = plan[i]
        k = slot * pool + (seen[slot] % pool)
        seen[slot] += 1
        noisy, sigma = images[k]
        return k, denoise_image(fn, params, noisy,
                                np.full((1,), sigma, np.float32))

    for slot in range(len(shapes)):
        for _ in range(traffic["warm_per_shape"]):
            noisy, sigma = images[slot * pool]
            denoise_image(fn, params, noisy, np.full((1,), sigma, np.float32))
    phases("warm-up")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    seen = [0] * len(shapes)
    sample = sample_plan(traffic, seed, plan)
    kept, lat, pixels, padded = {}, [], 0, []
    setup_s = time.time() - ctx["start_wall"]
    with tr.Window(ctx["trace"], dev) as win:
        deadline = time.perf_counter() + ctx["seconds"]
        i = 0
        while time.perf_counter() < deadline and i < len(plan):
            t0 = time.perf_counter()
            if ctx["trace"]:
                with torch.profiler.record_function("h100_bench.request"):
                    k, out = request(i)
            else:
                k, out = request(i)
            lat.append(time.perf_counter() - t0)
            h, w = out.shape[:2]
            pixels += h * w
            padded.append((-(-h // 32) * 32, -(-w // 32) * 32, h, w))
            if i in sample:
                kept[i] = (k, out)
            i += 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = win.summary()
    del fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pairs = [(got, ref.denoise(fields, params, *images[k], dev))
             for k, got in kept.values()]
    readings = check.image_readings(pairs)
    reference_s = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    shape_of = np.asarray([plan[j] for j in range(i)])
    half = i // 2
    print("latency ms, median by shape " + " ".join(
        f"{shapes[k][0]}x{shapes[k][1]}:{np.median(lat_ms[shape_of == k]):.2f}"
        for k in range(len(shapes)) if np.any(shape_of == k))
        + f"; halves {np.sum(lat_ms[:half]) / 1e3:.2f} s"
        f" / {np.sum(lat_ms[half:]) / 1e3:.2f} s for {half} / {i - half}"
        " requests", file=sys.stderr)
    return {
        "attempted": i, "failed": 0,
        "metrics": {
            "serve_mp_per_s": pixels / 1e6 / win.window_s,
            "serve_p95_ms": float(np.percentile(lat_ms, 95)),
            "peak_device_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        },
        "peak_bytes": peak, "readings": readings,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": 1, "reference_s": reference_s, "compared": len(pairs),
        "records": {"kind": "serve", "requests": padded,
                    "blind": fields["noise"]["value"] == "blind",
                    "dtype": fields["model"]["compute_dtype"],
                    "wall_s": win.window_s, "trace": summary,
                    "traces": [summary]},
    }
