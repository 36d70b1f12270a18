"""Args parser tests (port of the reference's coverage, Tests/args.cpp:15-160)
and headless runner end-to-end on a tiny scene."""
import io
import json
import os

import pytest

from rayzath_tpu.utils.args import Args, Arg, Option
from rayzath_tpu.headless import Headless, prepare_tasks


def make_args():
    return (Args()
            .arg(Arg({"-h", "--help"}, "help", []))
            .arg(Arg({"--headless"}, "headless",
                     [Option("task_path", True), Option("report_path", False)]))
            .arg(Arg({"-r"}, "render", [])))


def test_unknown_arg_throws():
    with pytest.raises(RuntimeError, match="Unknown argument"):
        make_args().parse(["--nope"])


def test_duplicate_arg_throws():
    with pytest.raises(RuntimeError, match="more than once"):
        make_args().parse(["-h", "-h"])


def test_required_option_missing_throws():
    with pytest.raises(RuntimeError, match="required"):
        make_args().parse(["--headless"])


def test_required_and_optional_options():
    got = make_args().parse(["--headless", "task.json", "out_dir", "-r"])
    assert got["--headless"] == ["task.json", "out_dir"]
    assert got["-r"] == []


def test_optional_option_stops_at_next_arg():
    got = make_args().parse(["--headless", "task.json", "-r"])
    assert got["--headless"] == ["task.json"]
    assert "-r" in got


def test_multiple_option_collects():
    args = Args().arg(Arg({"--files"}, "files", [Option("file", True, True)]))
    got = args.parse(["--files", "a", "b", "c"])
    assert got["--files"] == ["a", "b", "c"]


def test_usage_string_lists_variants():
    s = make_args().usage_string()
    assert "--headless" in s and "task_path" in s and "[report_path]" in s


# ---------------------------------------------------------------------------
# headless runner
# ---------------------------------------------------------------------------

SCENE = {
    "Objects": {
        "Material": [{"name": "white", "color": [0.8, 0.8, 0.8, 1.0],
                      "emission": 5.0}],
        "Mesh": [{"name": "box", "generate cube": {}}],
        "Camera": {"name": "cam", "position": [0, 0, -3],
                   "resolution": [16, 16], "aperture": 0.02,
                   "exposure time": 1.0},
        "Instance": [{"name": "box1", "Mesh": "box", "Material": ["white"]}],
    },
    "Material": {"emission": 0.5},
}


def test_prepare_tasks(tmp_path):
    scene_file = tmp_path / "scene.json"
    scene_file.write_text(json.dumps(SCENE))
    task_file = tmp_path / "tasks.json"
    task_file.write_text(json.dumps({"tasks": [
        {"scene path": "scene.json", "engine": ["CPU", "CUDAGPU"],
         "rpp": 8, "timeout": 30, "max depth": 4},
    ]}))
    tasks = prepare_tasks(str(task_file))
    assert len(tasks) == 1
    t = tasks[0]
    assert t.scene_path == str(scene_file)
    assert t.engine == ["CPU", "CUDAGPU"]  # the reference's engine names
    assert t.rpp == 8 and t.timeout == 30 and t.max_depth == 4


def test_unknown_engine_throws(tmp_path):
    task_file = tmp_path / "tasks.json"
    task_file.write_text(json.dumps({"tasks": [
        {"scene path": "x.json", "engine": "Metal"}]}))
    with pytest.raises(ValueError, match="Unknown engine"):
        prepare_tasks(str(task_file))


def test_headless_run_end_to_end(tmp_path):
    scene_file = tmp_path / "scene.json"
    scene_file.write_text(json.dumps(SCENE))
    task_file = tmp_path / "tasks.json"
    task_file.write_text(json.dumps({"tasks": [
        {"scene path": "scene.json", "rpp": 4, "timeout": 30, "max depth": 3},
    ]}))
    report_dir = str(tmp_path / "report")
    out = io.StringIO()
    code = Headless(out=out).run(str(task_file), report_dir, save_images=True)
    assert code == 0
    report = open(os.path.join(report_dir, "report.txt")).read()
    assert "Scene: scene.json" in report
    assert "max depth: 3" in report
    assert "rps" in report
    images = [f for f in os.listdir(report_dir) if f.endswith(".png")]
    assert len(images) == 1


def test_rpp_balancer_converges_and_bounds_recompiles():
    """The adaptive-rpp balancer (reference headless.cpp:277-296) on a
    synthetic renderer: per-cycle cost = fixed overhead + linear per-pass
    cost. It must converge near the 0.1 s target, stay clamped to [1,1024],
    and — because rpp is power-of-two quantized — request at most
    log2(1024)+1 distinct rpp values (each distinct value = one XLA compile)."""
    from rayzath_tpu.headless import balance_rpp, LOAD_TIME_TARGET

    for per_pass, overhead in [(0.02, 0.002), (0.0004, 0.001),
                               (0.5, 0.01), (1e-6, 1e-5)]:
        floaty, rpp = 1.0, 1
        seen = set()
        durations = []
        for _ in range(60):
            duration = overhead + per_pass * rpp
            durations.append(duration)
            seen.add(rpp)
            floaty, rpp = balance_rpp(floaty, rpp, duration)
            assert 1 <= rpp <= 1024
        assert len(seen) <= 11, f"{len(seen)} distinct rpp values = compiles"
        # steady state: the last cycles sit within the quantized band around
        # the target (a power-of-two grid can at worst straddle it by ~2x),
        # unless the cost function pins the clamp (per_pass too large/small)
        steady = durations[-5:]
        ideal = max(1.0, min(1024.0, LOAD_TIME_TARGET / per_pass))
        if 1.0 < ideal < 1024.0:
            for dur in steady:
                assert LOAD_TIME_TARGET / 3 < dur < LOAD_TIME_TARGET * 3, (
                    f"per_pass={per_pass}: steady cycle {dur:.4f}s far from "
                    f"target {LOAD_TIME_TARGET}s")
        elif ideal >= 1024.0:
            assert rpp == 1024
        else:
            assert rpp == 1
