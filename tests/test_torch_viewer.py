"""The port's viewer (``xfeatslam_tpu_torch/utils/viewer.py``), 3D map
export (``utils/map3d.py``) and their System wiring, on the CPU.

tests/test_viewer_server.py's cases and TestLiveViewer's
(tests/test_system_features.py) run on the port's classes; the map payload
equals the JAX package's on one atlas file loaded into both packages; a
short port System with ``viewer_dir`` and ``viewer_port`` writes the live
files, serves /state and takes commands, and exports the map page. The
renders are the port's own numpy drawings (no matplotlib or PIL): they are
read back by the port's PNG decoder and by cv2, the GIF by PIL."""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xfeatslam_tpu.slam import serialization as jser  # noqa: E402
from xfeatslam_tpu.utils import map3d as jmap3d  # noqa: E402
from xfeatslam_tpu_torch.ops import camera as tc  # noqa: E402
from xfeatslam_tpu_torch.slam import serialization as tser  # noqa: E402
from xfeatslam_tpu_torch.slam import settings as tset  # noqa: E402
from xfeatslam_tpu_torch.slam import system as tsys  # noqa: E402
from xfeatslam_tpu_torch.utils import map3d, png  # noqa: E402
from xfeatslam_tpu_torch.utils import synthetic as tsyn  # noqa: E402
from xfeatslam_tpu_torch.utils import viewer as tv  # noqa: E402
from xfeatslam_tpu_torch.utils.viewer import (  # noqa: E402
    LiveViewer, ViewerControls, ViewerServer)

HW, SCALE, N_FRAMES = (288, 384), 0.6, 6
KMAT = np.array([[517.3 * SCALE, 0, 318.6 * SCALE],
                 [0, 516.5 * SCALE, 255.3 * SCALE], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings():
    return tset.Settings(
        cam=tc.Pinhole.from_list([float(KMAT[0, 0]), float(KMAT[1, 1]),
                                  float(KMAT[0, 2]), float(KMAT[1, 2])]),
        bf=40.0 * SCALE, th_depth=3.0, depth_map_factor=1.0, n_features=600)


def _get(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A short port XFeat RGB-D System with the viewer and its panel on;
    six rendered frames (the viewer renders frames 0 and 5)."""
    root = tmp_path_factory.mktemp("viewer")
    seq = tsyn.make_sequence(n_frames=N_FRAMES, hw=HW, K=KMAT)
    viz = str(root / "viz")
    system = tsys.System(_settings(), tsys.Sensor.RGBD, device="cpu",
                         enable_loop_closing=False, viewer_dir=viz,
                         viewer_port=0)
    for i in range(N_FRAMES):
        system.track_rgbd(seq["images"][i], seq["depths"][i],
                          seq["timestamps"][i])
    yield system, seq, root, viz
    system.shutdown()


# ---- tests/test_viewer_server.py's ViewerControls cases ----

def test_gate_passes_when_not_paused():
    assert ViewerControls().gate(timeout=0.1) is True


def test_pause_blocks_and_step_releases_one_frame():
    c = ViewerControls()
    c.command("pause")
    released = []

    def worker():
        for _ in range(3):
            c.gate()
            released.append(time.monotonic())

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    time.sleep(0.15)
    assert released == []
    c.command("step")
    time.sleep(0.15)
    assert len(released) == 1
    c.command("step")
    time.sleep(0.15)
    assert len(released) == 2
    c.command("resume")
    t.join(timeout=1.0)
    assert len(released) == 3


def test_toggles_and_reset_consume():
    c = ViewerControls()
    assert c.command("toggle_localization") and c.localization
    assert c.command("toggle_localization") and not c.localization
    c.command("follow_on")
    c.command("view_side")
    st = c.state()
    assert st["follow"] and st["view"] == "side"
    c.command("reset")
    assert c.consume_reset() is True
    assert c.consume_reset() is False
    assert not c.command("no_such_command")


def test_stop_unblocks_gate():
    c = ViewerControls()
    c.command("pause")
    c.command("stop")
    assert c.gate(timeout=1.0) is False


@pytest.mark.parametrize("cmd", ViewerControls.COMMANDS)
def test_every_command_matches_jax(cmd):
    """Each command leaves the port's controls in the JAX package's
    state."""
    from xfeatslam_tpu.utils.viewer import ViewerControls as JaxControls

    t, j = ViewerControls(), JaxControls()
    for c in (t, j):
        c.command("pause")
        assert c.command(cmd)
    assert t.state() == j.state()
    assert t.consume_reset() == j.consume_reset()


# ---- the HTTP panel and the 3D endpoints ----

def test_panel_state_and_commands(tmp_path):
    c = ViewerControls()
    srv = ViewerServer(str(tmp_path), c, port=0)
    try:
        st, body = _get(srv.port, "/")
        assert st == 200 and b"step" in body and b"follow" in body
        assert b"/map3d" in body
        st, body = _get(srv.port, "/state")
        assert st == 200 and json.loads(body)["paused"] is False
        st, body = _get(srv.port, "/cmd?name=pause", method="POST")
        assert st == 200 and c.paused is True
        assert json.loads(body)["paused"] is True
        st, _ = _get(srv.port, "/cmd?name=bogus", method="POST")
        assert st == 400
        st, _ = _get(srv.port, "/live_map.png")
        assert st == 404  # before the first render
        (tmp_path / "live_map.png").write_bytes(b"\x89PNG fake")
        st, body = _get(srv.port, "/live_map.png")
        assert st == 200 and body.startswith(b"\x89PNG")
        st, body = _get(srv.port, "/map3d")
        assert st == 200 and b"webgl" in body and b"__EMBEDDED__" not in body
        st, _ = _get(srv.port, "/map3d.json")
        assert st == 404
        (tmp_path / "map3d.json").write_text(json.dumps({"seq": 3}))
        st, body = _get(srv.port, "/map3d.json")
        assert st == 200 and json.loads(body)["seq"] == 3
        assert _get(srv.port, "/nothing")[0] == 404
    finally:
        srv.close()


def _loop_map():
    slam_map, gt, _ = tsyn.make_loop_map(np.random.default_rng(0), n_kf=6,
                                         n_pts=120)
    return slam_map, [(float(i), R, t, None) for i, (R, t) in enumerate(gt)]


def test_payload_roundtrip_and_export(tmp_path):
    """TestMap3D's payload and export cases on the port's map."""
    slam_map, traj = _loop_map()
    p = map3d.map_payload(slam_map, trajectory=traj, seq=7)
    d = map3d.decode_payload(p)
    assert p["seq"] == 7 and d["pts"].shape == (p["n_pts"], 3)
    kids = sorted(slam_map.keyframes)
    np.testing.assert_allclose(
        d["kf_c"], np.stack([slam_map.keyframes[k].center() for k in kids]),
        atol=1e-6)
    np.testing.assert_allclose(d["kf_R"][0].reshape(3, 3),
                               slam_map.keyframes[kids[0]].R, atol=1e-6)
    cv = d["covis"]
    assert p["n_covis"] == len(cv)
    if len(cv):
        assert cv.max() < 6 and (cv[:, 0] < cv[:, 1]).all()
    assert d["traj"].shape == (len(traj), 3)
    html = open(map3d.export_html(p, str(tmp_path / "map.html"))).read()
    assert "__EMBEDDED__" not in html and p["pts"][:40] in html
    assert "webgl" in html and "requestAnimationFrame" in html


def test_map_payload_equals_jax_on_one_atlas(session, tmp_path):
    """The session's atlas saved by the port, loaded by both packages:
    the same payload, key for key."""
    system, seq, _, _ = session
    path = str(tmp_path / "atlas.zip")
    system.save_atlas(path)
    tm = tser.load_atlas(path).active
    jm = jser.load_atlas(path).active
    traj = system.tracking.trajectory
    a = map3d.map_payload(tm, trajectory=traj, seq=4, title="t")
    b = jmap3d.map_payload(jm, trajectory=traj, seq=4, title="t")
    assert a == b
    assert a["n_kf"] >= 1 and a["n_pts"] > 100
    # and on the live map itself
    assert map3d.map_payload(system.map, trajectory=traj) == \
        jmap3d.map_payload(system.map, trajectory=traj)
    # the page is the JAX package's
    assert map3d.MAP3D_HTML == jmap3d.MAP3D_HTML


def test_system_viewer_files_and_panel(session):
    system, seq, _, viz = session
    for name in ("live_frame.png", "live_map.png", "map3d.json"):
        assert os.path.exists(os.path.join(viz, name)), name
    assert not [f for f in os.listdir(viz) if ".tmp" in f]
    import cv2

    for name in ("live_frame.png", "live_map.png"):
        ours = png.read(os.path.join(viz, name))
        theirs = cv2.imread(os.path.join(viz, name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(ours, theirs[..., ::-1])
    frame = png.read(os.path.join(viz, "live_frame.png"))
    assert frame.shape == (HW[0] + 22, HW[1], 3)
    # keypoints drawn in the tracked colour
    assert (frame == np.array(tv._TRACKED, np.uint8)).all(-1).sum() > 50
    mp = png.read(os.path.join(viz, "live_map.png"))
    assert mp.shape == (500, 960, 3)
    assert (mp == np.array(tv._KEYFRAME, np.uint8)).all(-1).any()
    payload = json.load(open(os.path.join(viz, "map3d.json")))
    assert payload["seq"] == N_FRAMES and payload["n_kf"] >= 1
    port = system.viewer_server.port
    st, body = _get(port, "/state")
    assert st == 200 and json.loads(body)["paused"] is False
    st, body = _get(port, "/live_frame.png")
    assert st == 200 and body.startswith(b"\x89PNG")
    st, body = _get(port, "/cmd?name=view_top", method="POST")
    assert st == 200 and json.loads(body)["view"] == "top"
    # the System honours the panel's toggles on its next frame
    c = system.viewer_controls
    c.command("localization_on")
    system._apply_viewer_controls()
    assert system.tracking.only_tracking is True
    c.command("localization_off")
    system._apply_viewer_controls()
    assert system.tracking.only_tracking is False
    c.command("view_both")


def test_live_files_and_gif(session, tmp_path):
    """TestLiveViewer's case on the port's LiveViewer: three updates give
    the two PNGs and three history frames, close() a GIF that PIL reads
    back frame for frame."""
    system, seq, _, _ = session
    viz = str(tmp_path / "viz")
    v = LiveViewer(viz, every=1, max_history=10)
    for _ in range(3):
        v.update(seq["images"][0], system.tracking.last_frame, system.map,
                 trajectory=system.tracking.trajectory, state_text="OK")
    assert os.path.exists(os.path.join(viz, "live_frame.png"))
    assert os.path.exists(os.path.join(viz, "live_map.png"))
    assert len(v._hist) == 3
    gif = v.close()
    assert gif is not None and os.path.getsize(gif) > 1000
    from PIL import Image

    im = Image.open(gif)
    assert im.n_frames == 3
    want = tv.PALETTE[v._hist[0]]
    got = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(got, want)


def test_export_map_html(session, tmp_path):
    system = session[0]
    out = system.export_map_html(str(tmp_path / "map.html"))
    html = open(out).read()
    payload = json.loads(html.split("const EMBEDDED = ", 1)[1].split(
        ";\n", 1)[0])
    assert payload["n_kf"] == system.map.num_keyframes()
    assert payload["n_pts"] == system.map.num_points()


def test_quantize_and_text():
    rgb = np.array([[[0, 0, 0], [255, 255, 255], [128, 128, 128],
                     [51, 102, 204], [10, 200, 30]]], np.uint8)
    idx = tv.quantize(rgb)
    err = np.abs(tv.PALETTE[idx].astype(int) - rgb).max(-1)
    assert (err <= 26).all() and err[0, :4].max() <= 3
    m = tv.text_mask("OK 3", 2)
    assert m.shape == (14, 48) and m[:, 36:].any()
