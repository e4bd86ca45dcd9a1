"""Runs one cell of the benchmark once: set-up, a measured window, the
traced sub-window (with --trace 1), the check against the plain reference,
and the result line.

A cell is ``BENCHMARK.json``'s workload: its configuration file names the
model family (``families/<family>.py`` builds the program, the vision
reference and the work of a frame, and brings its language model: its
sizes, its reference check of the pages, its work counts and its ops,
``stcbench/lms``), its traffic file names the loop it runs (``ingest``,
the one there is).  The harness measures from outside the program: host
clocks ending in a synchronize, CUDA events around calls it wraps on the
session instance it built, a device-activity profiler over a fixed
sub-window, and the program's launch counters.  What the per-layer
metrics read is in the run record (``rec``) handed to
``metrics/<name>.py``.
"""

from __future__ import annotations

import bisect
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from stcbench import counts, traffic, weights
from stcbench.compare import rel, row_rel
from stcbench.reference.precision import Precision

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stc_tpu")
GIB = float(1 << 30)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, root: Path = ROOT) -> dict:
    """Everything BENCHMARK.json and the cell's files say about a cell."""
    bench = load_json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(m):
        return workload in m.get("workloads", [workload])

    return dict(
        cell=cell, config=load_json(root / conf["file"]),
        mix=load_json(HERE / "workloads" / f"{cell['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Hooks:
    """Wrappers on the session instance: spans (host clock or CUDA events)
    while ``on``, and, on a chunk the check reads, the capture of its
    vision output and of the pruner state it starts from (references to
    the program's own tensors: nothing is copied in the window).  A hook
    point that is gone is skipped, and its spans stay empty."""

    def __init__(self, run):
        self.run = run
        self.on = False
        self.capture = None
        self.host = {}
        self.events = {}

    def _span(self, name, clock, fn, *a, **k):
        if not self.on:
            return fn(*a, **k)
        if clock == "host" or self.run.dev.type != "cuda":
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.host.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **k)
        e1.record()
        self.events.setdefault(name, []).append((e0, e1))
        return out

    def wrap(self, obj, attr, name, clock, vision=False):
        orig = getattr(obj, attr, None)
        if orig is None:
            return

        def call(*a, **k):
            cap = self.capture if vision else None
            if cap is not None and len(a) >= 3:
                cap["pstate"] = a[2]
            out = self._span(name, clock, orig, *a, **k)
            if cap is not None:
                cap["flat"] = out[0][0].detach()
            return out

        setattr(obj, attr, call)

    def seconds(self, name):
        if name in self.host:
            return list(self.host[name])
        return [e0.elapsed_time(e1) / 1e3 for e0, e1 in self.events.get(
            name, [])]


class Profile:
    """torch.profiler over a fixed number of units of the window, device
    activity only (CUPTI: kernels, copies and the host's CUDA runtime
    calls; recording every host op as well doubles a chunk's time), read
    from its Chrome trace."""

    def __init__(self, dev):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts = [torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.data = None

    def __enter__(self):
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.data = read_trace(path)
        finally:
            os.unlink(path)
        return False


def read_trace(path) -> dict:
    """Device intervals, busy time, idle gaps and time by kernel name of a
    Chrome trace.  The window runs from the first to the last event; a gap
    is named by the host's last CUDA runtime call before it (a launch: the
    host was issuing; a copy or synchronize: it read a result back)."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev["dur"])
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((ev.get("name", ""), ts, dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            host.append((ev.get("name", ""), ts, dur))
    dev.sort(key=lambda e: e[1])
    host.sort(key=lambda e: e[1])
    if not dev:
        return dict(kernels=[], window_s=0.0, busy_s=0.0, gaps=[], ops=[])
    a = min([dev[0][1]] + [h[1] for h in host[:1]])
    b = max(max(ts + dur for _, ts, dur in dev),
            max((ts + dur for _, ts, dur in host), default=0.0))
    spans, cur = [], None
    for _, ts, dur in dev:
        s, e = ts, ts + dur
        if cur is None or s > cur[1]:
            if cur is not None:
                spans.append(cur)
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    spans.append(cur)
    busy = sum(e - s for s, e in spans)
    edges = [a] + [x for s, e in spans for x in (s, e)] + [b]
    starts = [ts for _, ts, _ in host]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            i = bisect.bisect_right(starts, s) - 1
            gaps.append(("host after " + (host[i][0] if i >= 0 else
                                          "nothing"), (e - s) / 1e6))
    ops = {}
    for name, _, dur in dev:
        key = name.split("(")[0].strip()[:96]
        ops[key] = ops.get(key, 0.0) + dur / 1e6
    return dict(kernels=dev, window_s=(b - a) / 1e6, busy_s=busy / 1e6,
                gaps=gaps, ops=sorted(ops.items(), key=lambda kv: -kv[1]))


def op_time(kernels, words, main: str) -> tuple:
    """(seconds, launches) of an op's kernels: those whose name contains
    one of `words`, a combine kernel counted with the kernel before it;
    launches counts the kernels named `main`."""
    total, n, last = 0.0, 0, False
    for name, _, dur in kernels:
        if "combine" in name:
            if last:
                total += dur / 1e6
            continue
        last = any(w in name for w in words)
        if last:
            total += dur / 1e6
            n += main in name
    return total, n


class Run:
    """One run of one cell."""

    def __init__(self, spec: dict, seed: int, seconds: float, trace: bool,
                 device, t_start: float, control: bool = False):
        self.spec, self.seed, self.seconds, self.trace = (spec, seed,
                                                          seconds, trace)
        self.cfg, self.mix = spec["config"], spec["mix"]
        self.dev = torch.device(device)
        self.t_start = t_start
        self.control = control
        self.fam = importlib.import_module(
            f"stcbench.families.{self.cfg['family']}")
        self.specs = self.fam.specs(self.cfg)
        self.lm = self.fam.lm(self.cfg, self.get, self.dev)
        self.hooks = Hooks(self)
        self.rec = dict(kind=self.mix["kind"], spans={}, profile=None,
                        op_kernels=self.lm.ops)
        self.peaks, self.held = [], 0
        self.records = []
        # (video, frame) of the chunk in flight; the pruner state each
        # chunk left and the cacher's choices of each cached chunk
        # (families/<family>.instrument)
        self.where = None
        self.pruner_states, self.cacher_choices = {}, {}

    # ------------------------------------------------------------ set-up --
    def get(self, name):
        return weights.make(self.seed, name, self.specs[name], self.dev)

    def build(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.session = self.fam.build(self.cfg, self.seed, self.dev)
        s = self.session
        h = self.hooks
        for attr in ("full", "cached"):
            h.wrap(s.vision, attr, "vision", "cuda", vision=True)
        h.wrap(s.vision, "preprocess", "preprocess", "host")
        h.wrap(s, "_append_flat", "append", "cuda")
        self.fam.instrument(s, self)
        self.init_ids = traffic.init_prompt(
            self.seed, self.lm.n_init, self.lm.vocab_size)
        s.encode_init_prompt(self.init_ids)

    def render(self, n_videos: int, n_frames: int):
        self.videos = [traffic.render_video(self.seed, v, n_frames, self.mix,
                                            self.dev)
                       for v in range(n_videos)]
        self.video, self.k = 0, 0

    def frame(self, v, k) -> np.ndarray:
        return self.videos[v % len(self.videos)][k:k + 1]

    def chunk(self, check_every: int, tag: str) -> float:
        """One 1-frame chunk of the current video: its seconds from being
        handed to the session to being in the store."""
        s = self.session
        mark = check_every and traffic.marked(self.seed, check_every, tag,
                                              self.video, self.k)
        if mark:
            self.hooks.capture = dict(v=self.video, k=self.k, kvs=s.kvs)
        self.where = (self.video, self.k)
        t0 = time.perf_counter()
        s.encode_video(self.frame(self.video, self.k))
        sync(self.dev)
        dt = time.perf_counter() - t0
        if mark:
            cap, self.hooks.capture = self.hooks.capture, None
            if "flat" in cap:
                self.records.append(cap)
        self.k += 1
        return dt

    def boundary(self):
        """A new video: the old store stays alive while a check record
        holds it, so the peak is read before that and counted apart."""
        s = self.session
        old = s.kvs
        if any(r["kvs"] is old for r in self.records):
            if self.dev.type == "cuda":
                self.peaks.append(torch.cuda.max_memory_allocated(self.dev)
                                  - self.held)
                torch.cuda.reset_peak_memory_stats(self.dev)
            self.held += sum(x.numel() * x.element_size() for x in old)
        s.clear_cache()
        s.encode_init_prompt(self.init_ids)
        self.video += 1
        self.k = 0

    def peak_bytes(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(max(self.peaks + [torch.cuda.max_memory_allocated(
            self.dev) - self.held]))

    # ------------------------------------------------------------ window --
    def window(self):
        units, lat, extra = 0, [], []
        prof_at = self.mix["profile_after"]
        prof_n = self.mix["profile_units"]
        prof = None
        launches0 = None
        sync(self.dev)
        self.hooks.on = self.trace
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        while True:
            if self.trace and units == prof_at:
                launches0 = self.launch_counts()
                t_enter = time.perf_counter()
                prof = Profile(self.dev).__enter__()
                deadline += time.perf_counter() - t_enter
                self.rec["profiled"] = (units, units + prof_n)
            if self.k == self.mix["video_frames"]:
                self.boundary()
            extra.append(dict(k=self.k))
            lat.append(self.chunk(self.mix["check_every"], "w"))
            units += 1
            if prof is not None and units == prof_at + prof_n:
                t_exit = time.perf_counter()
                prof.__exit__(None, None, None)
                # reading the trace is no part of the window's work
                deadline += time.perf_counter() - t_exit
                self.rec["profile"] = prof.data
                self.rec["launches"] = {
                    n: diff(c, launches0[n])
                    for n, c in self.launch_counts().items()}
                prof = None
            if time.perf_counter() >= deadline and prof is None:
                break
        window_s = time.perf_counter() - t0
        self.hooks.on = False
        # the work of each unit, from its shapes, once the window is over
        for e in extra:
            e.update(self.chunk_work(e["k"]))
        self.rec.update(window_s=window_s, units=units, lat=lat,
                        items=extra)
        for name in ("preprocess", "vision", "append"):
            self.rec["spans"][name] = self.hooks.seconds(name)

    # --------------------------------------------------------- the work --
    def cached(self, k: int) -> bool:
        """Whether frame k of a video takes the cacher's path."""
        c = self.cfg["session"]["cacher"]
        return c["strategy"] == "cacher" and k % c["cache_interval"] != 0

    def chunk_work(self, k: int):
        """The LM's op calls by op and the least time of chunk k of a
        video (k pages before it)."""
        lm = self.lm.chunk_work(k)
        vis = self.fam.vision_work(self.cfg, self.cached(k))
        return dict(ops=lm["ops"], least_s=(vis + lm["lm"]).least_s())

    def launch_counts(self) -> dict:
        """The program's launch counter of each op, None where it is
        gone."""
        return {n: op.launches() for n, op in self.lm.ops.items()}

    # -------------------------------------------------------------- fill --
    def setup(self):
        m = self.mix
        parts = self.rec["setup_parts"] = {}
        t = time.perf_counter()
        parts["start"] = t - self.t_start

        def lap(name):
            nonlocal t
            sync(self.dev)
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        if m["kind"] != "ingest":
            raise ValueError(f"no loop for traffic of kind {m['kind']!r}")
        self.build()
        lap("build")
        self.render(m["distinct_videos"], m["video_frames"])
        lap("render")
        # two frames of another video, then the boundary the window meets
        # between videos: its path is warm, and the stream the window
        # reads starts from a reset, as every later video does
        self.video = -1
        for _ in range(2):
            self.chunk(0, "")
        self.boundary()
        for _ in range(m["fill_frames"]):
            self.chunk(0, "")
        lap("fill")
    # ------------------------------------------------------------- check --
    @torch.no_grad()
    def check(self) -> dict:
        """The numbers compared, from the plain reference: {name: value},
        and with control the control's beside them under 'control.'."""
        out = {}
        self.session = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        recs = traffic.pick(self.seed, self.records, self.mix["check_chunks"],
                            "chunks")
        steps = [lambda: self.check_vision(recs), lambda: self.check_pages(
            recs), lambda: self.check_init({id(r["kvs"]): r["kvs"]
                                            for r in recs})]
        for step in steps:
            try:
                out.update(step())
            except (RuntimeError, ValueError, IndexError) as e:
                # a program that leaves nothing to compare fails the check
                print(f"stcbench: check failed: {e!r}", file=sys.stderr)
        return out

    def _control(self):
        """The control's precision, or None."""
        return Precision(True) if self.control else None

    def choices(self, v: int, k: int) -> dict:
        """The program's choices in frame k of video v, for the reference
        to follow at near-ties: the cacher's recomputed tokens of each
        layer (sel), and its chunk means in its channel order (delta: its
        pruner memory after the chunk less that before)."""
        st = self.pruner_states
        out = dict(sel=self.cacher_choices.get((v, k)))
        if (v, k) in st:
            after = st[(v, k)].mean_sum[0].float()
            out["delta"] = after if k == 0 or (v, k - 1) not in st else \
                after - st[(v, k - 1)].mean_sum[0].float()
        return out

    def check_vision(self, recs) -> dict:
        """Every checked chunk's features against the reference's from its
        frames, the worst chunk; with a pruner, the program's memory before
        each against the reference's own, from every earlier frame of the
        video, the worst.  The reference follows the program's choices at
        near-ties (reference/vision.py); the control is held against the
        reference's own choices."""
        if not recs:
            raise ValueError("no chunk to check")
        ref = self.fam.VisionReference(self.cfg, self.get, Precision())
        ctl = (self.fam.VisionReference(self.cfg, self.get, Precision(True))
               if self.control else None)
        mem, own, cmem = {}, {}, {}
        if hasattr(ref, "replay"):
            for v in sorted({r["v"] for r in recs}):
                upto = max(r["k"] for r in recs if r["v"] == v)
                frames = self.videos[v % len(self.videos)]
                prog = {k: self.choices(v, k) for k in range(upto + 1)}
                got = ref.replay(frames, upto, prog, own=ctl is not None)
                if ctl is not None:
                    got, mine = got
                    own.update({(v, k): m for k, m in mine.items()})
                    cmem.update({(v, k): m for k, m in ctl.replay(
                        frames, upto).items()})
                mem.update({(v, k): m for k, m in got.items()})
        out = {}
        for r in recs:
            v, k = r["v"], r["k"]
            cached = self.cached(k)
            prev = (torch.as_tensor(self.frame(v, k - 1), device=self.dev)
                    if cached else None)
            cur = torch.as_tensor(self.frame(v, k), device=self.dev)
            prog = dict(self.choices(v, k), idx=r.get("idx"))
            gaps = dict(feature_gap=row_rel(r["flat"], ref.chunk(
                prev, cur, cached, mem.get((v, k)), prog)))
            if (v, k) in mem:
                sums, n = self.fam.pruner_memory(r["pstate"])
                want, n_want = mem[(v, k)]
                gaps["memory_gap"] = max(rel(sums, want), abs(n - n_want))
            if ctl is not None:
                gaps["control.feature_gap"] = row_rel(
                    ctl.chunk(prev, cur, cached, cmem.get((v, k))),
                    ref.chunk(prev, cur, cached, own.get((v, k))))
                if (v, k) in cmem:
                    gaps["control.memory_gap"] = rel(cmem[(v, k)][0],
                                                     own[(v, k)][0])
            for name, g in gaps.items():
                out[name] = max(out.get(name, 0.0), g)
        out["cacher_ties_followed"] = ref.tower.followed
        return out

    def check_pages(self, recs) -> dict:
        """Each checked chunk's new page, every layer, from the program's
        own vision output and the program's earlier pages (the reference
        follows the stream step by step); the worst layer's gap."""
        gaps, ctl = self.lm.page_gaps(recs, self._control())
        out = dict(page_gap=max(gaps))
        if ctl is not None:
            out["control.page_gap"] = max(ctl)
        return out

    def check_init(self, stores: dict) -> dict:
        if not stores:
            return {}
        gap, ctl = self.lm.init_gaps(stores, self.init_ids, self._control())
        out = {"init_gap": gap}
        if ctl is not None:
            out["control.init_gap"] = ctl
        return out

    # ------------------------------------------------------------ result --
    def e2e(self, setup_s: float, peak: int) -> dict:
        r = self.rec
        lat = r["lat"]
        have = dict(setup_s=(setup_s, "s"), peak_mem_gib=(peak / GIB, "GiB"),
                    ingest_fps=(counts.rate(r["units"], r["window_s"]),
                                "frames/s"),
                    chunk_p95_ms=(counts.tail(lat, 0.95) * 1e3, "ms"))
        out = {}
        for m in self.spec["end_to_end"]:
            if m["name"] in have:
                v, unit = have[m["name"]]
                out[m["name"]] = dict(value=v, unit=m["unit"])
        return out

    def per_layer(self) -> dict:
        out = {}
        for m in self.spec["per_layer"]:
            path = HERE / "metrics" / f"{m['name']}.py"
            if not path.exists():
                continue
            sp = importlib.util.spec_from_file_location(
                "stcbench_metric_" + m["name"].replace(".", "_"), path)
            mod = importlib.util.module_from_spec(sp)
            sp.loader.exec_module(mod)
            v = mod.read(self.rec)
            if v is not None and math.isfinite(v):
                out[m["name"]] = dict(value=v, unit=m["unit"])
        return out


def diff(a, b):
    return None if a is None or b is None else a - b


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> dict:
    """Set-up, window, check; the result line as a dict (without the
    import check, which main makes).  With control the check computes the
    control as well, and its numbers, not the program's, are held to the
    limits; the program's stay among the readings."""
    run = Run(spec, seed, seconds, trace, device, t_start, control)
    run.setup()
    # set-up's objects stay: the window's collections need not scan them
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    run.window()
    gc.unfreeze()
    peak = run.peak_bytes()
    run.store = run.session.kvs
    metrics = run.per_layer() if trace else run.e2e(setup_s, peak)
    dev = run.dev
    device_info = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu", count=1, memory_peak_bytes=peak)
    prof = run.rec.get("profile")
    out = dict(attempted=run.rec["units"], failed=0)
    if trace and prof:
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    t_check = time.perf_counter()
    numbers = run.check()
    t_check = time.perf_counter() - t_check
    limits = spec["limits"]
    # with control, the control's numbers take the program's place
    side = "control." if control else ""
    checks = {k: dict(value=numbers.get(side + k), limit=limits[k])
              for k in limits}
    correct = out["failed"] == 0 and all(
        c["value"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    result = dict(correct=correct, **out, metrics=metrics,
                  device=device_info)
    if trace and prof:
        gaps = sorted(prof["gaps"], key=lambda g: -g[1])[:10]
        result["breakdown"] = dict(
            device_ops=[[n, s] for n, s in prof["ops"][:10]],
            idle_gaps=[[n, s] for n, s in gaps])
    result["card"] = card() if dev.type == "cuda" else "cpu"
    result["window_s"] = run.rec["window_s"]
    result["setup_parts"] = run.rec["setup_parts"]
    result["check_s"] = t_check
    if prof:
        result["profile_counts"] = dict(
            launches=run.rec.get("launches"),
            traced={n: op_time(prof["kernels"], op.words, op.main)[1]
                    for n, op in run.lm.ops.items()},
            kernels=len(prof["kernels"]))
    prof_at = run.rec.get("profiled")
    if prof_at:
        lat = run.rec["lat"]
        inner = [lat[i] for i in range(*prof_at) if i < len(lat)]
        outer = [x for i, x in enumerate(lat) if not prof_at[0] <= i
                 < prof_at[1]]
        if inner and outer:
            result["profiled_unit_s"] = [statistics.mean(inner),
                                         statistics.mean(outer)]
    result["readings"] = {k: v for k, v in numbers.items()
                          if k not in {side + c for c in limits}}
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = resolve(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"stcbench: the cell needs {chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    # one core for the process, whose threads inherit it: the host issues
    # every op of a chunk, and a thread that stays on its core issues at a
    # steadier pace (PERF.md)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"stcbench: loaded forbidden modules: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
