"""One run of one cell: set-up, the measured window, the trace, the check.

`run` returns the result object that `run.py` prints as its last line, and
the lines of the check for standard error. It takes its device from the
caller: `run.py` gives it the card, and refuses to start without one; the
CPU tests give it the CPU at a tiny size.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import torch

from harness import compare, manifest, reference, scene, trace, window

FORBIDDEN = ("jax", "jaxlib", "flax", "metalpathtracer_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _range(name: str):
    from torch.profiler import record_function

    return record_function("portbench/" + name)


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, program=None) -> tuple[dict, list[str]]:
    """One run. `program` is the module that drives the system under test
    (`harness.program`, or a stand-in of the tests); `t_start` the process's
    start on the host clock."""
    if program is None:
        from harness import program
    device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    width, height = int(traffic["width"]), int(traffic["height"])
    spp = int(traffic["spp_per_pass"])

    marks = [("start", time.perf_counter() - t_start)]
    arrays = scene.build(config["scene"], cell.root)
    marks.append(("scene", time.perf_counter() - t_start))
    dev_scene = program.upload(arrays, device)
    passes = program.Passes(dev_scene, config, traffic, seed)
    marks.append(("upload", time.perf_counter() - t_start))
    # warm-up: passes until one captures and warms nothing (every graph of
    # this shape is captured), at most four
    for _ in range(4):
        before = program.stats()
        passes.run()
        after = program.stats()
        if device.type != "cuda" or (after["captures"] == before["captures"]
                                     and after["eager_runs"] == before["eager_runs"]):
            break
    passes.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", setup_s))
    log(f"[setup] {setup_s:.3f} s (" + ", ".join(f"{k} at {v:.3f}" for k, v in marks)
        + f"), scene {arrays.kind.shape[0]} primitives ({arrays.n_triangles} "
        f"triangles), warm-up {program.stats()}")

    keep_mid = compare.mid_pass(seed)
    kept: dict = {}
    pass_s, rays = [], 0
    profiled = int(traffic.get("profiled_passes", 8)) if traced else 0
    prof = None
    stats0 = program.stats()
    tallies0 = program.tallies(device) if device.type == "cuda" else {}
    prof_lo = prof_hi = 0
    w0 = time.perf_counter()
    while True:
        if len(pass_s) == 0 and profiled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            program.profiling(True)
            prof.__enter__()
            prof_lo = time.perf_counter()
        profiling = prof is not None and len(pass_s) < profiled
        t0 = time.perf_counter()
        with _range("pass") if profiling else contextlib.nullcontext():
            img, r = passes.run()
        t1 = time.perf_counter()
        pass_s.append(t1 - t0)
        rays += r
        i = len(pass_s) - 1
        if i == 0 or i == keep_mid:  # the buffer is the next pass's
            kept[i] = img.copy()
        if profiling and len(pass_s) == profiled:
            prof_hi = time.perf_counter()
            prof.__exit__(None, None, None)
            program.profiling(False)
        if t1 - w0 >= seconds and (prof is None or len(pass_s) >= profiled):
            break
    window_s = time.perf_counter() - w0
    n = len(pass_s)
    kept[n - 1] = img.copy()
    spp_done = passes.samples_done
    stats = {k: program.stats()[k] - stats0[k] for k in stats0}
    tallies = program.tallies(device) if device.type == "cuda" else {}
    launches = {k: v[0] - tallies0.get(k, (0, 0))[0] for k, v in tallies.items()}
    peak = program.peak_bytes(device)
    found = forbidden_modules()
    log(f"[window] {n} passes in {window_s:.6f} s, {spp_done} samples a pixel, "
        f"{rays} rays ({rays / window_s / 1e6:.3f} Mrays/s by the program's count), "
        f"graphs {stats}, captures in the window {stats['captures']}, "
        f"kernel launches {launches}")
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")

    result_metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not traced:
        e2e = window.end_to_end(pass_s, window_s, width * height * spp, setup_s)
        result_metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in cell.end_to_end}
    breakdown = None
    busy_s = prof_window_s = None
    if traced:
        ev = trace.events(prof) if prof is not None else {"device": [], "host": []}
        lo, hi = _profile_bounds(ev["host"], prof_lo, prof_hi)
        ctx = trace.Context(n, stats, profiled, ev["device"], ev["host"], lo, hi,
                            manifest.layers(cell.root))
        for m in cell.per_layer:
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        busy_s, prof_window_s = program.device_busy(ctx.busy_ns, ctx.window_ns)
        breakdown = {"device_ops": trace.top_ops(ctx.device),
                     "idle_gaps": trace.idle_gaps(ctx.device, ctx.host, lo, hi)}
        log(f"[trace] {profiled} passes profiled, {len(ctx.device)} device events, "
            f"busy {busy_s:.6f} s of {prof_window_s:.6f} s (averaged over the cards), "
            f"layers (ns) {ctx.layer_ns}")

    # the check: the program's state is freed first
    del passes, dev_scene
    program.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    counts = {i: (i + 1) * spp for i in kept}
    if spp_done == n * spp:
        geo = reference.Geometry(arrays, device)
        basis = reference.camera_basis(config["camera"], width, height)
        pixels = compare.checked_pixels(geo, basis, width, height, seed,
                                        int(traffic["check_pixels"]))
        render = dict(config["render"], max_depth=int(traffic["max_depth"]))
        ref = compare.reference_images(geo, basis, width, height, render, seed,
                                       pixels, list(counts.values()))
        flat = {counts[i]: img.reshape(-1, 3)[pixels] for i, img in kept.items()}
        nums = compare.numbers(flat, ref)
        log(f"[check] passes {sorted(kept)} at {sorted(counts.values())} samples, "
            f"{pixels.size} pixels, reference {time.perf_counter() - t_ref:.3f} s")
    else:  # the images are not of the samples the passes asked for
        nums = {"gap_mean": None, "off_share": None}
        log(f"[check] the program holds {spp_done} samples a pixel after {n} passes "
            f"of {spp}: no reference computed")
    correct = spp_done == n * spp and all(nums[k] is not None and nums[k] <= cell.limits[k]
                                          for k in nums)
    checks = {k: {"value": nums[k], "limit": cell.limits[k]} for k in nums}
    checks["samples_a_pixel"] = {"value": spp_done, "limit": n * spp}
    lines = [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu"),
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    if traced:
        dev_info.update(busy_s=busy_s, window_s=prof_window_s)
    result = {"correct": bool(correct), "attempted": n,
              "failed": 0 if correct else len(kept), "metrics": result_metrics,
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, lines


def _profile_bounds(host_rows, lo_s: float, hi_s: float):
    """The profiled stretch on the trace's clock: from the first harness
    pass range's start to the last one's end."""
    passes = [r for r in host_rows if r[0] == "portbench/pass"]
    if passes:
        return min(r[1] for r in passes), max(r[2] for r in passes)
    return 0, int((hi_s - lo_s) * 1e9)
