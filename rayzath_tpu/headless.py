"""Headless benchmark runner (reference Application/headless.{hpp,cpp}).

Task JSON: ``{"tasks": [{"scene path": "...", "engine": ["CUDAGPU"|"CPU"],
"rpp": 1000, "timeout": 60}, ...]}`` (tasks may also be a single object;
engine names as in the reference task files, headless.cpp:94-124).
"CUDAGPU" renders on the device of the engine's platform decision
(engine.pick_device: the GPU, or the CPU when JAX runs on the CPU); "CPU"
pins the CPU device.

Per task x engine: load scene, render until ``rpp`` passes or timeout with
adaptive rpp load-balancing toward 0.1 s/cycle (sqrt-damped, clamp [1,1024] —
headless.cpp:277-296), live progress line with rays/s, optional image save,
and a ``report.txt`` with duration / traced rays / rays-per-second per entry
(headless.cpp:297-330).
"""
from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from .engine.config import RenderConfig, Tracing
from .engine.engine import pick_device
from .engine.renderer import Renderer
from .models.world import World
from .io.bitmap import save_image
from .utils.text import scientific_with_prefix

LOAD_TIME_TARGET = 0.1  # seconds per render cycle (headless.hpp)
ENGINES = ("CUDAGPU", "CPU")


@dataclass
class RenderTask:
    scene_path: str
    engine: List[str] = field(default_factory=lambda: ["CUDAGPU"])
    rpp: int = 1000
    timeout: float = 60.0
    max_depth: int = 16


@dataclass
class TaskResult:
    scene_path: str
    engine: str
    max_depth: int
    duration: float = 0.0
    total_traced_rays: int = 0

    @property
    def rays_per_second(self) -> float:
        return self.total_traced_rays / self.duration if self.duration > 0 else 0.0


def prepare_tasks(task_path: str) -> List[RenderTask]:
    """Parse the benchmark task file (headless.cpp:56-162)."""
    with open(task_path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if "tasks" not in doc:
        raise ValueError('File must contain "tasks" key.')
    entries = doc["tasks"]
    if isinstance(entries, dict):
        entries = [entries]
    if not isinstance(entries, list):
        raise ValueError("tasks's value have to be either an array or an object.")

    base = os.path.dirname(os.path.abspath(task_path))
    tasks = []
    for entry in entries:
        if not isinstance(entry, dict) or "scene path" not in entry:
            raise ValueError("Benchmark entry must contain a scene path key.")
        scene_path = str(entry["scene path"])
        if not os.path.isabs(scene_path):
            scene_path = os.path.normpath(os.path.join(base, scene_path))
        task = RenderTask(scene_path=scene_path)
        eng = entry.get("engine")
        if eng is not None:
            names = [eng] if isinstance(eng, str) else list(eng)
            task.engine = []
            for name in names:
                if name not in ENGINES:
                    raise ValueError(f'Unknown engine type "{name}"')
                task.engine.append(name)
        if "rpp" in entry:
            task.rpp = int(entry["rpp"])
        if "timeout" in entry:
            task.timeout = float(entry["timeout"])
        if "max depth" in entry:
            task.max_depth = int(entry["max depth"])
        tasks.append(task)
    return tasks


def balance_rpp(floaty_rpp: float, rpp: int, duration: float):
    """One rpp load-balancer update toward LOAD_TIME_TARGET seconds per cycle
    (reference Application/headless.cpp:277-296). Pure: returns the new
    (floaty_rpp, rpp).

    Deviation from the reference (which free-runs an integer rpp): the chosen
    rpp is quantized to powers of two and clamped to [1, 1024] — every
    distinct rpp is a separate XLA compile of the bounce scan (static length),
    so a free-running rpp would recompile nearly every cycle. The cost is a
    steady-state cycle time within ~[0.7x, 1.4x] of the target instead of
    exactly on it; the gain is at most log2(1024)+1 = 11 compiles ever."""
    relative_error = (duration - LOAD_TIME_TARGET) / LOAD_TIME_TARGET
    if abs(relative_error) > 0.05:
        ratio = (LOAD_TIME_TARGET / max(duration, 1e-6)) ** 0.5
        new_rpp = floaty_rpp * ratio
        floaty_rpp = (floaty_rpp + new_rpp) * 0.5
        clamped = min(max(floaty_rpp, 1.0), 1024.0)
        rpp = 1 << max(0, int(clamped).bit_length() - 1)
    return floaty_rpp, rpp


class Headless:
    """The headless render loop with adaptive rpp (reference Headless)."""

    def __init__(self, out=sys.stdout):
        self.out = out
        self._floaty_rpp = 1.0
        self._rpp = 1

    def run(self, task_path: str, report_path: Optional[str] = None,
            save_images: bool = False) -> int:
        tasks = prepare_tasks(task_path)
        report_dir = report_path or os.path.join(
            os.path.dirname(os.path.abspath(task_path)),
            time.strftime("benchmark_%Y%m%d_%H%M%S"))
        os.makedirs(report_dir, exist_ok=True)

        results: List[TaskResult] = []
        for task in tasks:
            results += self.execute_task(task, report_dir, save_images)
        self.generate_report(report_dir, results)
        return 0

    # -- one task (headless.cpp:163-270) --------------------------------------
    def execute_task(self, task: RenderTask, report_dir: str,
                     save_images: bool) -> List[TaskResult]:
        print(f"Loading {os.path.basename(task.scene_path)}", file=self.out)
        t0 = time.perf_counter()
        world = World()
        world.load_scene(task.scene_path)
        print(f"Loaded in: {time.perf_counter() - t0:.3f}s\n", file=self.out)

        results = []
        for engine_name in task.engine:
            cfg = RenderConfig(tracing=Tracing(max_depth=task.max_depth, rpp=1))
            renderer = Renderer(world, cfg, device=pick_device(
                "cpu" if engine_name == "CPU" else None))
            result = TaskResult(task.scene_path, engine_name, task.max_depth)

            self._floaty_rpp = 1.0
            self._rpp = 1
            traced = 0
            self.render(renderer, min(self._rpp, task.rpp))  # warm-up/compile
            start = time.perf_counter()
            last = start
            while traced < task.rpp:
                rpp = min(self._rpp, task.rpp - traced)
                self.render(renderer, rpp)
                now = time.perf_counter()
                task_duration = now - start
                pass_duration = now - last
                last = now
                traced += rpp
                rays = rpp * sum(c.width * c.height
                                 for c in world.cameras if c.enabled)
                result.total_traced_rays += rays
                rps = rays / max(pass_duration, 1e-9)
                msg = (f"\rRendering... {traced}/{task.rpp} +{rpp} [rpp] "
                       f"({traced / task.rpp * 100.0:.2f}%) | "
                       f"{scientific_with_prefix(int(rps))} rps | "
                       f"{task_duration:.3f}s (timeout: {task.timeout:.3f}s)")
                print(msg, end="", file=self.out, flush=True)
                if task_duration >= task.timeout:
                    break
            result.duration = time.perf_counter() - start
            print(f"\nRendered in: {result.duration:.3f}s\n", file=self.out)

            if save_images:
                for cam in world.cameras:
                    if not cam.enabled:
                        continue
                    name = (f"{os.path.basename(task.scene_path)}_{cam.name}_"
                            f"{scientific_with_prefix(result.total_traced_rays)}_"
                            f"{engine_name}.png").replace(" ", "_")
                    save_image(os.path.join(report_dir, name),
                               renderer.image(cam))
            results.append(result)
        return results

    def render(self, renderer: Renderer, rpp: int) -> None:
        """One blocking render cycle + rpp load balancing toward 0.1 s
        (headless.cpp:272-296)."""
        t0 = time.perf_counter()
        renderer.render(rpp=rpp)   # blocks until the accumulation is ready
        duration = time.perf_counter() - t0
        self._floaty_rpp, self._rpp = balance_rpp(self._floaty_rpp, self._rpp,
                                                  duration)

    # -- report (headless.cpp:297-330) ----------------------------------------
    def generate_report(self, report_dir: str, results: List[TaskResult]) -> None:
        path = os.path.join(report_dir, "report.txt")
        print(f"Generating report in {path}", file=self.out)
        with open(path, "w", encoding="utf-8") as f:
            for r in results:
                f.write(f"Scene: {os.path.basename(r.scene_path)}\n")
                f.write(f"\tengine: {r.engine} | max depth: {r.max_depth}\n")
                f.write(f"\tduration: {r.duration:.3f}s | "
                        f"traced {scientific_with_prefix(r.total_traced_rays)} rays "
                        f"({scientific_with_prefix(int(r.rays_per_second))} rps)\n")


def main(argv: Optional[List[str]] = None) -> int:
    """CLI entry (reference Application/main.cpp:41-77)."""
    from .utils.args import Args, Arg, Option
    arg_def = (Args()
               .arg(Arg({"-h", "--help"}, "Prints help message.", []))
               .arg(Arg({"--headless"},
                        "Execute rendering tasks without UI and generate a report.",
                        [Option("task_path", True), Option("report_path", False)]))
               .arg(Arg({"-r", "--render"},
                        "When specified --headless, also saves rendered images.", []))
               .arg(Arg({"--profile"},
                        "Capture a jax.profiler trace of the run into a directory.",
                        [Option("trace_dir", True)]))
               .arg(Arg({"--scaling"},
                        "Measure multi-device rays/s scaling efficiency.",
                        [Option("scene", False)]))
               .arg(Arg({"--view"},
                        "Serve a live progressive viewer (orbit/pan/zoom/"
                        "pick) for a scene .json or built-in scene name.",
                        [Option("scene", True), Option("port", False)])))
    args = arg_def.parse(list(sys.argv[1:] if argv is None else argv))

    if "-h" in args or "--help" in args:
        print(arg_def.usage_string())
        return 0
    if "--scaling" in args:
        from . import scenes
        from .parallel.scaling import measure_scaling, format_report
        params = args["--scaling"]
        scene_fn = scenes.SCENES[params[0]] if params else scenes.cornell_box
        print(format_report(measure_scaling(scene_fn)))
        return 0
    if "--view" in args:
        from . import scenes
        from .viewer import Viewer
        params = args["--view"]
        name = params[0]
        if name in scenes.SCENES:
            world = scenes.SCENES[name](512, 512)
        else:
            world = World()
            world.load_scene(name)
        port = int(params[1]) if len(params) > 1 else 8760
        Viewer(world).serve(port=port)
        return 0
    if "--headless" in args:
        params = args["--headless"]
        task_path = params[0] if params else ""
        report_path = params[1] if len(params) > 1 else None
        save = "-r" in args or "--render" in args
        if "--profile" in args:
            import jax
            with jax.profiler.trace(args["--profile"][0]):
                return Headless().run(task_path, report_path, save)
        return Headless().run(task_path, report_path, save)
    print(arg_def.usage_string())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
