"""Scene-editing surface (reference Application/explorer.cpp:1-815 +
properties.cpp:1-908 + save_modals.cpp): explorer tree, live property
edits that restart progressive accumulation, and save-from-editor."""
import json
import os
import threading
import time
import urllib.request

import numpy as np

import rayzath_tpu as rz
from rayzath_tpu import editor
from rayzath_tpu.viewer import Viewer


def test_scene_tree_lists_all_containers():
    w = rz.scenes.multi_light(32, 32)
    tree = editor.scene_tree(w)
    assert tree["camera"] and tree["instance"] and tree["material"]
    assert tree["spot_light"], "multi_light has spot lights"
    assert tree["world_material"][0]["editable"]
    names = [i["name"] for i in tree["instance"]]
    assert len(names) == len(w.instances)


def test_get_set_props_bumps_content_version():
    w = rz.scenes.cornell_box(32, 32)
    v0 = w.content_version()
    props = editor.get_props(w, "material", 0)
    assert any(f["attr"] == "roughness" for f in props["fields"])
    out = editor.set_prop(w, "material", 0, "roughness", 0.37)
    got = next(f for f in out["fields"] if f["attr"] == "roughness")
    assert abs(got["value"] - 0.37) < 1e-6
    assert w.content_version() != v0

    # rgba accepts rgb and pads alpha
    editor.set_prop(w, "material", 0, "color", [0.2, 0.3, 0.4])
    c = np.asarray(w.materials[0].color)
    assert np.allclose(c, [0.2, 0.3, 0.4, 1.0])


def test_set_prop_rejects_uneditable():
    w = rz.scenes.cornell_box(32, 32)
    try:
        editor.set_prop(w, "material", 0, "name", "nope")
        assert False, "should have raised"
    except KeyError:
        pass


def test_instance_transform_edit_moves_geometry():
    w = rz.scenes.textured_room(32, 24)
    from rayzath_tpu.models.device_scene import compile_world
    a = compile_world(w)
    inst_idx = next(i for i, it in enumerate(w.instances)
                    if it.name == "ball 1")
    editor.set_prop(w, "instance", inst_idx, "transform.position",
                    [0.9, 0.8, 0.7])
    b = compile_world(w)
    assert np.allclose(w.instances[inst_idx].transform.position,
                       [0.9, 0.8, 0.7])
    assert not np.allclose(np.asarray(a.tri_v0), np.asarray(b.tri_v0))


def test_light_direction_renormalized():
    w = rz.scenes.multi_light(32, 32)
    editor.set_prop(w, "spot_light", 0, "direction", [2.0, 0.0, 0.0])
    d = np.asarray(w.spot_lights[0].direction)
    assert np.allclose(np.linalg.norm(d), 1.0, atol=1e-6)


def _req(port, path, body=None):
    url = f"http://127.0.0.1:{port}{path}"
    if body is None:
        r = urllib.request.urlopen(url, timeout=30)
    else:
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        r = urllib.request.urlopen(req, timeout=30)
    return r.status, r.read()


def test_viewer_edit_endpoints_restart_render(tmp_path):
    """The VERDICT item-7 'done' bar: edit a material color and a light
    emission from the HTTP surface, see accumulation restart, save the
    scene."""
    world = rz.scenes.multi_light(32, 32)
    # dense XLA intersection: on the CPU the BVH walk's kernels run under
    # the Pallas interpreter, whose first cycle can blow the test's wait —
    # the HTTP/restart logic under test is identical either way
    v = Viewer(world, rz.RenderConfig(tracing=rz.Tracing(max_depth=2, rpp=2),
                                      brute_force_threshold=100000),
               rpp_per_cycle=2)
    server = v.make_server(port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    v.start()
    try:
        for _ in range(300):
            if v.stats()["pass_count"] > 2:
                break
            time.sleep(0.1)
        assert v.stats()["pass_count"] > 2

        code, body = _req(port, "/tree")
        tree = json.loads(body)
        assert code == 200 and tree["material"]

        code, body = _req(port, "/props?type=material&idx=0")
        assert code == 200
        props = json.loads(body)
        assert props["fields"]

        # edit a material color -> progressive accumulation restarts
        code, body = _req(port, "/edit", {
            "type": "material", "idx": 0, "attr": "color",
            "value": [0.9, 0.1, 0.1, 1.0]})
        assert code == 200
        # edit a light emission too
        code, body = _req(port, "/edit", {
            "type": "spot_light", "idx": 0, "attr": "emission", "value": 55.0})
        assert code == 200
        assert abs(world.spot_lights[0].emission - 55.0) < 1e-6
        # wait for a render cycle: pass_count must have reset below its
        # pre-edit value and climb again from the restart
        for _ in range(300):
            if 0 < v.stats()["pass_count"] <= 4:
                break
            time.sleep(0.1)
        assert 0 < v.stats()["pass_count"] <= 6, "accumulation did not restart"

        out = str(tmp_path / "edited.json")
        code, body = _req(port, "/save", {"path": out})
        assert code == 200 and json.loads(body)["saved"] == out
        # round-trip: the edited values persisted
        w2 = rz.World()
        w2.load_scene(out)
        mat = next(m for m in w2.materials
                   if m.name == world.materials[0].name)
        assert np.allclose(np.asarray(mat.color)[:3], [0.9, 0.1, 0.1],
                           atol=1e-3)
    finally:
        v.stop()
        server.shutdown()


def test_viewer_load_new_destroy_roundtrip(tmp_path):
    """Load-modal parity (VERDICT item 7): drive load -> new -> edit ->
    destroy -> save over HTTP; container edits flow through the Versioned
    restart path."""
    world = rz.scenes.cornell_box(32, 32)
    scene_path = str(tmp_path / "exported" / "scene.json")
    world.save_scene(scene_path)

    start_world = rz.World()
    start_world.create_camera(resolution=(32, 32))
    v = Viewer(start_world,
               rz.RenderConfig(tracing=rz.Tracing(max_depth=2, rpp=2),
                               brute_force_threshold=100000),
               rpp_per_cycle=2)
    server = v.make_server(port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        code, body = _req(port, "/load", {"path": scene_path})
        assert code == 200
        loaded = json.loads(body)
        assert loaded["objects"]["instance"] > 0

        code, body = _req(port, "/new", {"type": "material",
                                         "params": {"name": "fresh"}})
        assert code == 200
        idx = json.loads(body)["idx"]
        code, body = _req(port, "/edit", {"type": "material", "idx": idx,
                                          "attr": "emission", "value": 2.5})
        assert code == 200
        assert v.world.materials[idx].emission == 2.5

        n_before = len(v.world.materials)
        code, body = _req(port, "/destroy", {"type": "material", "idx": idx})
        assert code == 200
        assert len(v.world.materials) == n_before - 1

        out_path = str(tmp_path / "resaved" / "scene.json")
        code, body = _req(port, "/save", {"path": out_path})
        assert code == 200
        assert os.path.exists(out_path)

        # bad requests answer 400, not a dead server
        try:
            _req(port, "/new", {"type": "nonsense"})
            assert False, "expected HTTP 400"
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        server.shutdown()
        server.server_close()
