"""Interactive 3D map view: the MapDrawer role of ORB-SLAM3's Pangolin
window (map points, keyframe frusta, covisibility graph, spanning tree,
trajectory, follow-camera).

Counterpart of ``xfeatslam_tpu/utils/map3d.py``, on the port's map (the
same host-side structures), with the same payload and page. The map is
drawn by a self-contained WebGL page (orbit, pan and zoom with the mouse,
top and side presets, follow-camera), either exported as one standalone
.html file (data embedded, no network, no external script) or served live
by ``utils/viewer.ViewerServer`` (``/map3d`` polls ``/map3d.json``, which
``LiveViewer`` refreshes atomically at each update).
"""

from __future__ import annotations

import base64
import json

import numpy as np


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def map_payload(slam_map, trajectory=None, max_points: int = 60000,
                seq: int = 0, title: str = "map") -> dict:
    """Serializable scene snapshot of a Map (single-writer: call from the
    tracking thread, like every other map read).

    Keys: pts (N,3 f32), kf_c (M,3 f32 centers), kf_R (M,9 f32 row-major
    world->camera rotations), covis (E,2 u32 indices into kf arrays),
    tree (P,2 u32 spanning-tree edges), traj (T,3 f32) — each base64 of
    the raw little-endian buffer, plus counts and a monotonically
    increasing ``seq`` the live page uses to skip unchanged rebuilds."""
    alive = slam_map.points.alive[: slam_map.points.n]
    pts = slam_map.points.pos[: slam_map.points.n][alive][:max_points]
    pts = np.asarray(pts, np.float32).reshape(-1, 3)

    kids = sorted(k for k, kf in slam_map.keyframes.items() if not kf.bad)
    row = {k: i for i, k in enumerate(kids)}
    if kids:
        kf_c = np.stack([slam_map.keyframes[k].center() for k in kids])
        kf_R = np.stack([slam_map.keyframes[k].R.reshape(9) for k in kids])
    else:
        kf_c = np.zeros((0, 3), np.float32)
        kf_R = np.zeros((0, 9), np.float32)

    covis = [(row[a], row[b])
             for a, edges in slam_map.covis.items() if a in row
             for b in edges if b in row and b > a]
    tree = [(row[k], row[slam_map.keyframes[k].parent]) for k in kids
            if slam_map.keyframes[k].parent in row]

    traj = np.zeros((0, 3), np.float32)
    if trajectory is not None and len(trajectory):
        traj = np.stack([(-R.T @ t) for (_ts, R, t, _s) in trajectory])

    return {
        "seq": int(seq),
        "title": str(title),
        "n_pts": int(len(pts)),
        "n_kf": int(len(kids)),
        "n_covis": int(len(covis)),
        "n_tree": int(len(tree)),
        "n_traj": int(len(traj)),
        "pts": _b64(pts.astype(np.float32)),
        "kf_c": _b64(kf_c.astype(np.float32)),
        "kf_R": _b64(kf_R.astype(np.float32)),
        "covis": _b64(np.asarray(covis, np.uint32).reshape(-1, 2)),
        "tree": _b64(np.asarray(tree, np.uint32).reshape(-1, 2)),
        "traj": _b64(traj.astype(np.float32)),
    }


def decode_payload(payload: dict) -> dict:
    """Inverse of map_payload (tests / offline analysis)."""
    def f32(key, w):
        raw = base64.b64decode(payload[key])
        return np.frombuffer(raw, np.float32).reshape(-1, w)

    def u32(key):
        raw = base64.b64decode(payload[key])
        return np.frombuffer(raw, np.uint32).reshape(-1, 2)

    return {"pts": f32("pts", 3), "kf_c": f32("kf_c", 3),
            "kf_R": f32("kf_R", 9), "covis": u32("covis"),
            "tree": u32("tree"), "traj": f32("traj", 3)}


def export_html(payload: dict, path: str) -> str:
    """Write a standalone interactive map file (embedded data, no
    server). Returns ``path``."""
    html = MAP3D_HTML.replace("__EMBEDDED__", json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)
    return path


# The page: a dependency-free WebGL1 renderer (no external script; the
# scene is points and lines, which plain WebGL covers in one small
# shader). Orbit: drag; pan: shift/right
# drag; zoom: wheel; keys: t top view, s side view, b both(free), f follow
# camera, r reset.
MAP3D_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>xfeatslam_tpu 3D map</title><style>
html,body { margin:0; height:100%; background:#14141a; color:#ccc;
            font-family:monospace; overflow:hidden; }
#hud { position:fixed; left:8px; top:6px; pointer-events:none;
       text-shadow:0 0 4px #000; font-size:12px; white-space:pre; }
canvas { width:100%; height:100%; display:block; }
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
"use strict";
const EMBEDDED = __EMBEDDED__;
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl", {antialias: true});
const hud = document.getElementById("hud");

// ---- tiny mat4 ----
function perspective(fov, asp, near, far) {
  const f = 1 / Math.tan(fov / 2), nf = 1 / (near - far);
  return [f/asp,0,0,0, 0,f,0,0, 0,0,(far+near)*nf,-1, 0,0,2*far*near*nf,0];
}
function lookAt(eye, at, up) {
  const z = norm3(sub3(eye, at)), x = norm3(cross3(up, z)),
        y = cross3(z, x);
  return [x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0,
          -dot3(x,eye),-dot3(y,eye),-dot3(z,eye),1];
}
function mul4(a, b) {
  const o = new Array(16);
  for (let i = 0; i < 4; i++) for (let j = 0; j < 4; j++) {
    let s = 0;
    for (let k = 0; k < 4; k++) s += a[k*4+j] * b[i*4+k];
    o[i*4+j] = s;
  }
  return o;
}
const sub3 = (a,b)=>[a[0]-b[0],a[1]-b[1],a[2]-b[2]];
const add3 = (a,b)=>[a[0]+b[0],a[1]+b[1],a[2]+b[2]];
const scale3 = (a,s)=>[a[0]*s,a[1]*s,a[2]*s];
const dot3 = (a,b)=>a[0]*b[0]+a[1]*b[1]+a[2]*b[2];
const cross3 = (a,b)=>[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
                       a[0]*b[1]-a[1]*b[0]];
const norm3 = a=>{const l=Math.hypot(a[0],a[1],a[2])||1;return scale3(a,1/l);};

// ---- shader ----
const VS = `attribute vec3 p; uniform mat4 mvp; uniform float ps;
void main(){ gl_Position = mvp*vec4(p,1.0); gl_PointSize = ps; }`;
const FS = `precision mediump float; uniform vec4 col;
void main(){ gl_FragColor = col; }`;
function compile(type, src) {
  const s = gl.createShader(type);
  gl.shaderSource(s, src); gl.compileShader(s);
  return s;
}
const prog = gl.createProgram();
gl.attachShader(prog, compile(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, compile(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const aP = gl.getAttribLocation(prog, "p");
const uMVP = gl.getUniformLocation(prog, "mvp");
const uCol = gl.getUniformLocation(prog, "col");
const uPS = gl.getUniformLocation(prog, "ps");
gl.enableVertexAttribArray(aP);

// ---- scene buffers ----
function b64f32(s){const b=atob(s),u=new Uint8Array(b.length);
  for(let i=0;i<b.length;i++)u[i]=b.charCodeAt(i);
  return new Float32Array(u.buffer);}
function b64u32(s){const b=atob(s),u=new Uint8Array(b.length);
  for(let i=0;i<b.length;i++)u[i]=b.charCodeAt(i);
  return new Uint32Array(u.buffer);}
function buf(data){const b=gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);
  return {b:b, n:data.length/3};}

let scene = null, seq = -1, title = "";
function buildScene(d) {
  const pts = b64f32(d.pts), kfc = b64f32(d.kf_c), kfr = b64f32(d.kf_R);
  const covis = b64u32(d.covis), tree = b64u32(d.tree),
        traj = b64f32(d.traj);
  // keyframe frusta: 8 segments each, wireframe pyramid in camera frame
  // mapped to world by X_w = C + R^T X_c (R is world->camera, row-major)
  const W = 0.06, Hh = 0.045, Z = 0.08;
  const corners = [[-W,-Hh,Z],[W,-Hh,Z],[W,Hh,Z],[-W,Hh,Z]];
  const fr = [];
  const nk = kfc.length / 3;
  for (let i = 0; i < nk; i++) {
    const C = [kfc[3*i], kfc[3*i+1], kfc[3*i+2]], R = kfr.slice(9*i, 9*i+9);
    const w = corners.map(v => add3(C, [
      R[0]*v[0]+R[3]*v[1]+R[6]*v[2],
      R[1]*v[0]+R[4]*v[1]+R[7]*v[2],
      R[2]*v[0]+R[5]*v[1]+R[8]*v[2]]));
    for (let j = 0; j < 4; j++) {
      fr.push(...C, ...w[j]);                    // apex -> corner
      fr.push(...w[j], ...w[(j+1)%4]);           // rim
    }
  }
  const edgeLines = (idx) => {
    const o = new Float32Array(idx.length * 3);
    for (let e = 0; e < idx.length; e++)
      for (let k = 0; k < 3; k++) o[3*e+k] = kfc[3*idx[e]+k];
    return o;
  };
  const trajSeg = new Float32Array(Math.max(0, traj.length/3 - 1) * 6);
  for (let i = 0; i + 3 < traj.length; i += 3)
    trajSeg.set(traj.subarray(i, i + 6), i * 2);
  scene = {
    rawPts: pts,
    pts: buf(pts), fr: buf(new Float32Array(fr)),
    covis: buf(edgeLines(covis)), tree: buf(edgeLines(tree)),
    traj: buf(trajSeg),
    last: traj.length >= 3 ?
      [traj[traj.length-3], traj[traj.length-2], traj[traj.length-1]] :
      [0, 0, 0],
    counts: {pts: d.n_pts, kf: d.n_kf, covis: d.n_covis, traj: d.n_traj},
  };
  title = d.title || "";
  if (cam.auto && pts.length) fitView(pts);
}

// ---- camera ----
const cam = {yaw: -0.6, pitch: 0.4, dist: 6, target: [0,0,0],
             follow: false, auto: true};
function fitView(pts) {
  const c = [0,0,0];
  const n = pts.length / 3;
  for (let i = 0; i < pts.length; i += 3)
    { c[0]+=pts[i]/n; c[1]+=pts[i+1]/n; c[2]+=pts[i+2]/n; }
  let r = 0.5;
  for (let i = 0; i < pts.length; i += 3)
    r = Math.max(r, Math.hypot(pts[i]-c[0], pts[i+1]-c[1], pts[i+2]-c[2]));
  cam.target = c; cam.dist = r * 2.2; cam.auto = false;
}
function eye() {
  const cp = Math.cos(cam.pitch), sp = Math.sin(cam.pitch);
  const cy = Math.cos(cam.yaw), sy = Math.sin(cam.yaw);
  return add3(cam.target, scale3([cp*sy, sp, cp*cy], cam.dist));
}

// ---- interaction ----
let drag = null;
canvas.addEventListener("mousedown", e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.button === 2 || e.shiftKey};
});
window.addEventListener("mouseup", () => drag = null);
window.addEventListener("mousemove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) {
    const E = eye(), z = norm3(sub3(E, cam.target)),
          x = norm3(cross3([0,1,0], z)), y = cross3(z, x);
    const s = cam.dist * 0.0015;
    cam.target = add3(cam.target,
      add3(scale3(x, -dx * s), scale3(y, dy * s)));
  } else {
    cam.yaw -= dx * 0.008;
    cam.pitch = Math.min(1.55, Math.max(-1.55, cam.pitch + dy * 0.008));
  }
});
canvas.addEventListener("wheel", e => {
  cam.dist *= Math.exp(e.deltaY * 0.001);
  e.preventDefault();
}, {passive: false});
canvas.addEventListener("contextmenu", e => e.preventDefault());
window.addEventListener("keydown", e => {
  if (e.key === "t") { cam.yaw = 0; cam.pitch = 1.55; }       // top (x-z)
  else if (e.key === "s") { cam.yaw = 0; cam.pitch = 0; }     // side (x-y)
  else if (e.key === "b") { cam.yaw = -0.6; cam.pitch = 0.4; }
  else if (e.key === "f") cam.follow = !cam.follow;
  else if (e.key === "r") { if (scene) fitView(scene.rawPts); }
});

// ---- render loop ----
function draw(b, mode, col, ps) {
  if (!b.n) return;
  gl.bindBuffer(gl.ARRAY_BUFFER, b.b);
  gl.vertexAttribPointer(aP, 3, gl.FLOAT, false, 0, 0);
  gl.uniform4fv(uCol, col);
  gl.uniform1f(uPS, ps);
  gl.drawArrays(mode, 0, b.n);
}
function frame() {
  const w = canvas.clientWidth, h = canvas.clientHeight;
  if (canvas.width !== w || canvas.height !== h) {
    canvas.width = w; canvas.height = h;
  }
  gl.viewport(0, 0, w, h);
  gl.clearColor(0.078, 0.078, 0.102, 1);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);
  if (scene) {
    if (cam.follow) cam.target = scene.last;
    const mvp = mul4(perspective(0.9, w / h, 0.01, 1000),
                     lookAt(eye(), cam.target, [0, 1, 0]));
    gl.uniformMatrix4fv(uMVP, false, mvp);
    draw(scene.pts, gl.POINTS, [0.65, 0.65, 0.65, 0.9], 2.0);
    draw(scene.covis, gl.LINES, [0.35, 0.65, 0.35, 0.5], 1);
    draw(scene.tree, gl.LINES, [0.8, 0.8, 0.3, 0.8], 1);
    draw(scene.fr, gl.LINES, [0.25, 0.45, 0.95, 0.95], 1);
    draw(scene.traj, gl.LINES, [0.9, 0.25, 0.25, 0.95], 1);
    const c = scene.counts;
    hud.textContent = `${title}\\n${c.pts} points  ${c.kf} keyframes  ` +
      `${c.covis} covis edges  ${c.traj} frames\\n` +
      `drag orbit | shift-drag pan | wheel zoom | ` +
      `t top  s side  b free  f follow(${cam.follow ? "on" : "off"})  r reset`;
  } else {
    hud.textContent = "waiting for map data...";
  }
  requestAnimationFrame(frame);
}
requestAnimationFrame(frame);

// ---- data source: embedded (standalone export) or polled (live) ----
if (EMBEDDED) { buildScene(EMBEDDED); seq = EMBEDDED.seq; }
else {
  const poll = async () => {
    try {
      const r = await fetch("/map3d.json?t=" + Date.now());
      if (r.ok) {
        const d = await r.json();
        if (d.seq !== seq) { seq = d.seq; buildScene(d); }
      }
    } catch (e) {}
    setTimeout(poll, 1000);
  };
  poll();
}
</script></body></html>
"""
