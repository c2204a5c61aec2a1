"""Headless visualization: frame and map renders, a live session viewer
and its HTTP control panel.

Counterpart of ``xfeatslam_tpu/utils/viewer.py``, in the role of
ORB-SLAM3's viewer thread (FrameDrawer: keypoints and a state banner;
MapDrawer: map points, keyframes, covisibility graph, trajectory; the
Pangolin menu). The JAX package draws with matplotlib and PIL; the port's
host may have neither, so it draws into numpy arrays itself (points,
rings, line segments and a built-in 5x7 bitmap font), writes PNGs with
``utils/png.py`` and the session's animation with a GIF writer of its own
(``write_gif``). The renders are not pixel-equal to matplotlib's; the
files, their atomic swaps and the server's endpoints and commands are the
JAX package's.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import png

# colors of the JAX package's renders
_GRAY_POINTS = (136, 136, 136)
_COVIS = (136, 187, 136)
_KEYFRAME = (51, 102, 204)
_TRAJECTORY = (204, 51, 51)
_TRACKED = (51, 204, 51)
_DETECTED = (68, 136, 255)
_TEXT = (20, 20, 20)
_BANNER = (235, 235, 235)

# a 5x7 bitmap font: seven rows of five bits (the high bit on the left) a
# glyph, as hex pairs; text is drawn upper-cased, unknown characters as '?'
_FONT_HEX = {
    " ": "00000000000000", "0": "0E11131519110E", "1": "040C040404040E",
    "2": "0E11010204081F", "3": "1F02040201110E",
    "4": "02060A121F0202", "5": "1F101E0101110E", "6": "0608101E11110E",
    "7": "1F010204080808", "8": "0E11110E11110E", "9": "0E11110F01020C",
    "A": "0E1111111F1111", "B": "1E11111E11111E", "C": "0E11101010110E",
    "D": "1C12111111121C", "E": "1F10101E10101F", "F": "1F10101E101010",
    "G": "0E11101711110F", "H": "1111111F111111",
    "I": "0E04040404040E", "J": "0702020202120C", "K": "11121418141211",
    "L": "1010101010101F", "M": "111B1515111111", "N": "11111915131111",
    "O": "0E11111111110E", "P": "1E11111E101010", "Q": "0E11111115120D",
    "R": "1E11111E141211", "S": "0F10100E01011E", "T": "1F040404040404",
    "U": "1111111111110E", "V": "11111111110A04",
    "W": "1111111515150A", "X": "11110A040A1111",
    "Y": "1111110A040404", "Z": "1F01020408101F", ".": "00000000000C0C",
    ",": "000000000C0408", ":": "000C0C000C0C00", "-": "0000001F000000",
    "|": "04040404040404", "/": "00010204081000", "(": "02040808080402",
    ")": "08040202020408", "@": "0E11010D15150E", "%": "18190204081303",
    "+": "0004041F040400", "=": "00001F001F0000", "_": "0000000000001F",
    "?": "0E110102040004", "!": "04040404040004", "#": "0A0A1F0A1F0A0A",
    "'": "0C040800000000", "<": "02040810080402", ">": "08040201020408",
    "[": "0E08080808080E", "]": "0E02020202020E", "*": "0004150E150400",
}


def _glyph(ch: str) -> np.ndarray:
    rows = _FONT_HEX.get(ch, _FONT_HEX["?"])
    bits = [int(rows[2 * r:2 * r + 2], 16) for r in range(7)]
    return np.array([[(b >> (4 - c)) & 1 for c in range(5)] for b in bits],
                    bool)


_GLYPHS = {ch: _glyph(ch) for ch in _FONT_HEX}


def text_mask(text: str, scale: int = 1) -> np.ndarray:
    """The (7*scale, 6*scale*len) bool mask of ``text`` in the built-in
    font, a column of space after each glyph."""
    cols = [np.pad(_GLYPHS.get(ch, _GLYPHS["?"]), ((0, 0), (0, 1)))
            for ch in text.upper()]
    m = np.concatenate(cols, 1) if cols else np.zeros((7, 0), bool)
    return np.kron(m, np.ones((scale, scale), bool)).astype(bool)


def draw_text(img, x: int, y: int, text: str, color, scale: int = 1):
    """Draw ``text`` with its top-left corner at (x, y), clipped to the
    image."""
    m = text_mask(text, scale)
    H, W = img.shape[:2]
    h, w = m.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if x1 <= x0 or y1 <= y0:
        return
    sub = m[y0 - y:y1 - y, x0 - x:x1 - x]
    img[y0:y1, x0:x1][sub] = color


def _plot(img, xs, ys, color, r: int = 0):
    """Fill a (2r+1)-pixel square at each (x, y), clipped to the image."""
    H, W = img.shape[:2]
    xi = np.round(np.asarray(xs, np.float64)).astype(np.int64)
    yi = np.round(np.asarray(ys, np.float64)).astype(np.int64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            x, y = xi + dx, yi + dy
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            img[y[ok], x[ok]] = color


def _rings(img, xs, ys, color, radius: float):
    """A circle outline of ``radius`` pixels around each (x, y)."""
    n = max(8, int(2 * np.pi * radius) + 1)
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    _plot(img, (xs[:, None] + radius * np.cos(a)).ravel(),
          (ys[:, None] + radius * np.sin(a)).ravel(), color)


def _segments(img, p0, p1, color):
    """Line segments from each p0 (E,2) to each p1 (E,2), pixel (x, y)."""
    p0, p1 = np.asarray(p0, np.float64), np.asarray(p1, np.float64)
    if len(p0) == 0:
        return
    d = p1 - p0
    # clip each segment's length to a few image sizes before sampling
    n = int(min(np.abs(d).max(), 4 * sum(img.shape[:2]))) + 2
    t = np.linspace(0.0, 1.0, n)
    pts = p0[:, None, :] + d[:, None, :] * t[None, :, None]
    _plot(img, pts[..., 0].ravel(), pts[..., 1].ravel(), color)


def render_frame(gray: np.ndarray, frame, path: str, state_text: str = ""):
    """FrameDrawer's view: the image, keypoints (tracked in green, the
    others in blue), a state banner and the counts. Writes a PNG at
    ``path`` and returns the (H + 22, W, 3) uint8 render."""
    g = np.asarray(gray)
    if g.dtype != np.uint8:
        g = np.clip(g * (255.0 if g.max() <= 1.0 else 1.0), 0, 255).astype(
            np.uint8)
    if g.ndim == 3:
        g = g[..., 0]
    H, W = g.shape
    banner = 22
    img = np.empty((H + banner, W, 3), np.uint8)
    img[:banner] = _BANNER
    img[banner:] = g[..., None]
    v = np.asarray(frame.valid)
    kp = np.asarray(frame.kpts)
    tracked = v & (np.asarray(frame.mp_ids) >= 0) & np.asarray(frame.inlier)
    free = v & ~tracked
    _rings(img, kp[free, 0], kp[free, 1] + banner, _DETECTED, 2.0)
    _rings(img, kp[tracked, 0], kp[tracked, 1] + banner, _TRACKED, 3.0)
    draw_text(img, 4, 4, state_text or f"frame {frame.fid}", _TEXT, 2)
    legend = [(f"{int(free.sum())} detected", _DETECTED),
              (f"{int(tracked.sum())} tracked", _TRACKED)]
    for k, (s, c) in enumerate(legend):
        y = H + banner - 10 * (len(legend) - k) - 2
        img[y - 1:y + 8, W - 6 * len(s) - 6:W - 2] = (255, 255, 255)
        draw_text(img, W - 6 * len(s) - 4, y, s, c)
    png.write(path, img)
    return img


def render_map(slam_map, path: str, trajectory=None, title: str = "map",
               max_points: int = 20000, center=None, half_width: float = 6.0,
               view: str = "both", panel: int = 480):
    """Top (x-z) and side (x-y) views of the map: points, keyframes,
    covisibility edges and the frame trajectory, each panel ``panel``
    pixels square with equal axes. ``center``: the world point the axes are
    centred on with +-``half_width`` (the follow-camera mode), else the
    axes fit the data; ``view``: "both" | "top" | "side". Writes a PNG at
    ``path`` and returns the render."""
    alive = slam_map.points.alive[: slam_map.points.n]
    X = np.asarray(slam_map.points.pos[: slam_map.points.n][alive]
                   [:max_points], np.float64).reshape(-1, 3)
    centers = {k: kf.center() for k, kf in slam_map.keyframes.items()}
    C = (np.stack(list(centers.values())).astype(np.float64) if centers
         else np.zeros((0, 3)))
    T = np.zeros((0, 3))
    if trajectory is not None and len(trajectory):
        T = np.stack([(-R.T @ t) for (_ts, R, t, _s) in trajectory]).astype(
            np.float64)
    edges = [(k, k2) for k, e in slam_map.covis.items() if k in centers
             for k2 in e if k2 in centers and k2 > k]

    panels = [(0, 2, "x-z (top)"), (0, 1, "x-y (side)")]
    if view == "top":
        panels = panels[:1]
    elif view == "side":
        panels = panels[1:]
    head = 20
    img = np.full((head + panel, panel * len(panels), 3), 255, np.uint8)
    for p, (i, j, name) in enumerate(panels):
        sub = img[head:, p * panel:(p + 1) * panel]
        if center is not None:
            lo = np.array([center[i], center[j]], np.float64) - half_width
            span = 2.0 * half_width
        else:
            allp = np.concatenate([X, C, T])[:, [i, j]]
            if len(allp):
                lo, hi = allp.min(0), allp.max(0)
            else:
                lo, hi = np.zeros(2), np.ones(2)
            span = max(float((hi - lo).max()), 1e-3) * 1.1
            lo = (lo + hi) / 2.0 - span / 2.0

        def to_px(P):
            P = np.asarray(P, np.float64).reshape(-1, 3)
            x = (P[:, i] - lo[0]) / span * (panel - 1)
            y = (panel - 1) - (P[:, j] - lo[1]) / span * (panel - 1)
            return np.stack([x, y], -1)

        if len(X):
            q = to_px(X)
            _plot(sub, q[:, 0], q[:, 1], _GRAY_POINTS)
        if edges:
            a = to_px(np.stack([centers[k] for k, _ in edges]))
            b = to_px(np.stack([centers[k2] for _, k2 in edges]))
            _segments(sub, a, b, _COVIS)
        if len(T) > 1:
            q = to_px(T)
            _segments(sub, q[:-1], q[1:], _TRAJECTORY)
        if len(C):
            q = to_px(C)
            _plot(sub, q[:, 0], q[:, 1], _KEYFRAME, r=2)
        sub[:, 0] = sub[:, -1] = sub[0] = sub[-1] = (160, 160, 160)
        draw_text(img, p * panel + 4, 4, f"{title} - {name}", _TEXT, 2)
        legend = [(f"{len(X)} points", _GRAY_POINTS),
                  (f"{len(C)} keyframes", _KEYFRAME)]
        if len(T):
            legend.append(("trajectory", _TRAJECTORY))
        for k, (s, c) in enumerate(legend):
            draw_text(sub, 6, 6 + 10 * k, s, c)
    png.write(path, img)
    return img


# the GIF palette: a 6x6x6 colour cube, then 40 grays
_CUBE = np.arange(6) * 51
_GRAYS = np.round(np.arange(40) * 255.0 / 39.0)
PALETTE = np.concatenate([
    np.stack(np.meshgrid(_CUBE, _CUBE, _CUBE, indexing="ij"), -1)
    .reshape(-1, 3),
    np.repeat(_GRAYS[:, None], 3, 1)]).astype(np.uint8)


def quantize(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) indices into ``PALETTE``: the nearer of
    the cube's colour and the gray ramp's level."""
    x = rgb.astype(np.int32)
    c = np.clip((x + 25) // 51, 0, 5)
    ci = c[..., 0] * 36 + c[..., 1] * 6 + c[..., 2]
    ce = ((x - c * 51) ** 2).sum(-1)
    g = np.clip(np.round(x.mean(-1) * 39.0 / 255.0).astype(np.int32), 0, 39)
    ge = ((x - _GRAYS[g][..., None]) ** 2).sum(-1)
    return np.where(ge < ce, 216 + g, ci).astype(np.uint8)


def _lzw_literal(indices: np.ndarray) -> bytes:
    """8-bit palette indices as a GIF LZW stream of literal codes, 9 bits
    each: a clear code before every 250 codes keeps the decoder's table,
    and so its code width, from growing."""
    flat = indices.ravel().astype(np.int64)
    chunk = 250
    n = len(flat)
    n_chunks = -(-n // chunk)
    codes = np.full(n + n_chunks + 1, 256, np.int64)  # 256: clear
    pos = np.arange(n) + np.arange(n) // chunk + 1
    codes[pos] = flat
    codes[-1] = 257  # end of information
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).ravel()
    return np.packbits(bits, bitorder="little").tobytes()


def write_gif(path: str, frames, delay_cs: int = 20) -> str:
    """An animated GIF (looping, ``delay_cs`` hundredths of a second a
    frame) of (H, W) ``PALETTE`` index frames of one size. Returns
    ``path``."""
    H, W = frames[0].shape
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0),
           PALETTE.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    for f in frames:
        data = _lzw_literal(f)
        blocks = b"".join(bytes([len(data[k:k + 255])]) + data[k:k + 255]
                          for k in range(0, len(data), 255))
        out += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0),
                b"\x08", blocks, b"\x00"]
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path


class LiveViewer:
    """The live viewer of a running session (the reference's viewer thread
    over the current frame and map), headless: every ``every``-th frame the
    frame and map renders are atomically swapped into
    ``<out_dir>/live_frame.png`` and ``live_map.png``, and the 3D scene
    into ``map3d.json`` (served by ``ViewerServer`` at ``/map3d``). The
    frame renders are kept (at most ``max_history``, every ``gif_scale``-th
    pixel) and assembled into ``session.gif`` by ``close()``."""

    def __init__(self, out_dir: str, every: int = 5, max_history: int = 120,
                 gif_scale: int = 2):
        self.out = out_dir
        self.every = max(1, int(every))
        self.max_history = max_history
        self.gif_scale = gif_scale
        self._n = 0
        self._hist = []
        os.makedirs(out_dir, exist_ok=True)

    def update(self, gray, frame, slam_map, trajectory=None,
               state_text: str = "", follow_center=None, view: str = "both"):
        import json

        from . import map3d

        self._n += 1
        if (self._n - 1) % self.every:
            return
        fp = os.path.join(self.out, "live_frame.png")
        mp = os.path.join(self.out, "live_map.png")
        # each file written beside its name, then renamed over it: a
        # watcher never sees a torn file
        rgb = render_frame(gray, frame, fp + ".tmp.png", state_text=state_text)
        os.replace(fp + ".tmp.png", fp)
        render_map(slam_map, mp + ".tmp.png", trajectory=trajectory,
                   title=f"map @ frame {self._n - 1}",
                   center=follow_center, view=view)
        os.replace(mp + ".tmp.png", mp)
        payload = map3d.map_payload(slam_map, trajectory=trajectory,
                                    seq=self._n,
                                    title=f"map @ frame {self._n - 1}")
        j = os.path.join(self.out, "map3d.json")
        with open(j + ".tmp", "w") as f:
            json.dump(payload, f)
        os.replace(j + ".tmp", j)
        if len(self._hist) < self.max_history:
            s = self.gif_scale
            self._hist.append(quantize(rgb[::s, ::s]))

    def close(self):
        """Assemble ``<out_dir>/session.gif`` from the rendered history;
        None with fewer than two frames."""
        if len(self._hist) < 2:
            return None
        return write_gif(os.path.join(self.out, "session.gif"), self._hist)


class ViewerControls:
    """Control state shared by a UI and the tracking loop: the reference
    viewer's menu (follow camera, top or camera view, localization mode,
    reset, step-by-step, stop).

    The tracker calls ``gate()`` before each frame; it blocks while paused
    (``step`` releases one frame) and the System applies the toggles
    (localization mode, reset) itself. Every method is thread-safe: a
    ``ViewerServer`` changes the state from its HTTP thread."""

    COMMANDS = ("pause", "resume", "toggle_pause", "step", "follow_on",
                "follow_off", "toggle_follow", "view_top", "view_side",
                "view_both", "localization_on", "localization_off",
                "toggle_localization", "reset", "stop")

    def __init__(self):
        import threading

        self._cv = threading.Condition()
        self.paused = False
        self.follow = False
        self.view = "both"
        self.localization = False
        self.stopped = False
        self._steps = 0
        self._reset = False

    def command(self, name: str) -> bool:
        """Apply a named command; False for an unknown name."""
        if name not in self.COMMANDS:
            return False
        with self._cv:
            if name == "pause":
                self.paused = True
            elif name == "resume":
                self.paused = False
            elif name == "toggle_pause":
                self.paused = not self.paused
            elif name == "step":
                self.paused = True
                self._steps += 1
            elif name == "follow_on":
                self.follow = True
            elif name == "follow_off":
                self.follow = False
            elif name == "toggle_follow":
                self.follow = not self.follow
            elif name in ("view_top", "view_side", "view_both"):
                self.view = name[5:]
            elif name == "localization_on":
                self.localization = True
            elif name == "localization_off":
                self.localization = False
            elif name == "toggle_localization":
                self.localization = not self.localization
            elif name == "reset":
                self._reset = True
            elif name == "stop":
                self.stopped = True
            self._cv.notify_all()
        return True

    def gate(self, timeout=None) -> bool:
        """Block while paused (a pending step releases one frame). False
        once ``stop`` was issued (the caller ends the session)."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self.paused and self._steps == 0 and not self.stopped:
                wait = 0.05
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        break
                self._cv.wait(wait)
            if self._steps > 0:
                self._steps -= 1
            return not self.stopped

    def consume_reset(self) -> bool:
        with self._cv:
            r, self._reset = self._reset, False
            return r

    def state(self) -> dict:
        with self._cv:
            return {"paused": self.paused, "follow": self.follow,
                    "view": self.view, "localization": self.localization,
                    "stopped": self.stopped, "pending_steps": self._steps}


_PANEL_HTML = """<!doctype html>
<html><head><title>xfeatslam_tpu viewer</title><style>
body {{ font-family: sans-serif; background: #1b1b1f; color: #ddd; }}
img {{ max-width: 48%; border: 1px solid #444; }}
button {{ margin: 2px; padding: 6px 10px; }}
#state {{ font-family: monospace; color: #9c9; }}
</style></head><body>
<h3>xfeatslam_tpu live session</h3>
<div>
<button onclick="cmd('toggle_pause')">pause / resume</button>
<button onclick="cmd('step')">step</button>
<button onclick="cmd('toggle_follow')">follow camera</button>
<button onclick="cmd('view_top')">top view</button>
<button onclick="cmd('view_side')">side view</button>
<button onclick="cmd('view_both')">both views</button>
<button onclick="cmd('toggle_localization')">localization mode</button>
<button onclick="cmd('reset')">reset map</button>
<button onclick="cmd('stop')">stop</button>
<a href="/map3d" target="_blank" style="color:#8cf">3D map</a>
<span id="state"></span>
</div>
<img id="frame" src="/live_frame.png"/>
<img id="map" src="/live_map.png"/>
<script>
async function cmd(n) {{
  const r = await fetch('/cmd?name=' + n, {{method: 'POST'}});
  document.getElementById('state').textContent = await r.text();
}}
setInterval(() => {{
  for (const id of ['frame', 'map'])
    document.getElementById(id).src = '/live_' + id + '.png?t=' + Date.now();
  fetch('/state').then(r => r.text()).then(t =>
    document.getElementById('state').textContent = t);
}}, 700);
</script></body></html>
"""


class ViewerServer:
    """A minimal HTTP UI over a live session (standard library only): the
    ``LiveViewer``'s renders and a control panel whose buttons drive a
    ``ViewerControls``, reachable from any browser.

    Endpoints: GET / (the panel), GET /live_frame.png | /live_map.png,
    GET /map3d (the 3D page) | /map3d.json, GET /state (JSON),
    POST /cmd?name=<one of ViewerControls.COMMANDS>.
    """

    def __init__(self, out_dir: str, controls: "ViewerControls",
                 port: int = 0, host: str = "127.0.0.1"):
        import http.server
        import json
        import threading
        import urllib.parse

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _file(self, name, ctype, missing: bytes, missing_type):
                try:
                    with open(os.path.join(outer.out_dir, name), "rb") as f:
                        self._send(200, f.read(), ctype)
                except OSError:
                    self._send(404, missing, missing_type)

            def _handle(self):
                u = urllib.parse.urlparse(self.path)
                if u.path == "/":
                    self._send(200, _PANEL_HTML.encode(), "text/html")
                elif u.path == "/map3d":
                    from .map3d import MAP3D_HTML

                    page = MAP3D_HTML.replace("__EMBEDDED__", "null")
                    self._send(200, page.encode(), "text/html")
                elif u.path == "/map3d.json":
                    self._file("map3d.json", "application/json", b"{}",
                               "application/json")
                elif u.path in ("/live_frame.png", "/live_map.png"):
                    self._file(u.path[1:], "image/png", b"not rendered yet",
                               "text/plain")
                elif u.path == "/state":
                    self._send(200, json.dumps(controls.state()).encode(),
                               "application/json")
                elif u.path == "/cmd":
                    q = urllib.parse.parse_qs(u.query)
                    ok = controls.command((q.get("name") or [""])[0])
                    self._send(200 if ok else 400,
                               json.dumps(controls.state()).encode(),
                               "application/json")
                else:
                    self._send(404, b"?", "text/plain")

            do_GET = _handle
            do_POST = _handle

        self.out_dir = out_dir
        self.controls = controls
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
