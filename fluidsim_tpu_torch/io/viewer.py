"""Interactive viewer — a copy of ``fluidsim_tpu/io/viewer.py`` (numpy and
``http.server`` only), reading ``.vdb`` frames with the port's reader.
The live equivalent of the reference's ``vdb_view``
(``openvdb/viewer/Viewer.h:59-66``: open a window, display grids, orbit
camera, clip box; ``openvdb/viewer/ClipBox.h:47-83``).

A GLFW window is impossible in a headless image, so interactivity is
delivered the way everything else in this framework is — over a local
port: ``python -m fluidsim_tpu_torch.cli view --interactive
sim/mygrids*.vdb`` starts a tiny HTTP
server whose single self-contained page renders the grids' active voxels
as a WebGL point cloud with

  * mouse-drag orbit + wheel zoom       (Viewer camera, ``Camera.h``)
  * x/y/z clip-plane sliders            (``ClipBox.h`` equivalent)
  * frame playback across files         (vdb_view's multi-grid stepping)
  * value-scaled point color

No external assets (zero-egress: the page embeds all JS inline; WebGL 1
is in every browser).  Frame payloads are binary float32 (x, y, z, value)
quadruples, gzip-encoded.

Data sources: ``.vdb`` files (read back through ``io.vdb.read_vdb``) or
``.npz`` checkpoints (particle positions).
"""

from __future__ import annotations

import gzip
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>fluidsim view</title>
<style>
 body { margin:0; background:#10141a; color:#cfd8e3; font:13px sans-serif; }
 #hud { position:fixed; top:8px; left:8px; background:rgba(16,20,26,.8);
        padding:8px 10px; border-radius:6px; }
 #hud input[type=range] { width:110px; vertical-align:middle; }
 canvas { display:block; width:100vw; height:100vh; }
 .k { color:#7aa2f7 }
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
 <div id="title"></div>
 <div>frame <span id="fi">0</span>/<span id="fn">0</span>
   <span class="k">[space]</span> play <span class="k">[,.]</span> step</div>
 <div>clip x <input type="range" id="cx" min="0" max="1" step="0.01" value="1"></div>
 <div>clip y <input type="range" id="cy" min="0" max="1" step="0.01" value="1"></div>
 <div>clip z <input type="range" id="cz" min="0" max="1" step="0.01" value="1"></div>
 <div>drag: orbit &nbsp; wheel: zoom</div>
 <div id="stats"></div>
</div>
<script>
const canvas = document.getElementById('c');
const gl = canvas.getContext('webgl');
const VS = `attribute vec4 p; uniform mat4 mvp; uniform vec3 clip;
uniform float b; varying float v;
void main(){
  vec3 q = p.xyz / b;            // [-1, 1]
  float vis = step(abs(q.x), clip.x) * step(abs(q.y), clip.y)
            * step(abs(q.z), clip.z);
  gl_Position = mvp * vec4(p.xyz, 1.0);
  gl_PointSize = vis * 2.0;
  v = p.w;
}`;
const FS = `precision mediump float; varying float v;
void main(){
  vec3 lo = vec3(0.15, 0.35, 0.8), hi = vec3(0.9, 0.95, 1.0);
  gl_FragColor = vec4(mix(lo, hi, clamp(v, 0.0, 1.0)), 1.0);
}`;
function sh(t, s){ const o = gl.createShader(t); gl.shaderSource(o, s);
  gl.compileShader(o);
  if(!gl.getShaderParameter(o, gl.COMPILE_STATUS))
    throw gl.getShaderInfoLog(o);
  return o; }
const prog = gl.createProgram();
gl.attachShader(prog, sh(gl.VERTEX_SHADER, VS));
gl.attachShader(prog, sh(gl.FRAGMENT_SHADER, FS));
gl.linkProgram(prog); gl.useProgram(prog);
const loc = { p: gl.getAttribLocation(prog, 'p'),
              mvp: gl.getUniformLocation(prog, 'mvp'),
              clip: gl.getUniformLocation(prog, 'clip'),
              b: gl.getUniformLocation(prog, 'b') };
const buf = gl.createBuffer();
let npts = 0, bound = 1, frames = [], fi = 0, playing = false;
let yaw = 0.7, pitch = 0.45, dist = 3.2;

function mat(){
  const a = canvas.width / canvas.height, f = 1.0 / Math.tan(0.35);
  const zn = 0.01, zf = 50.0;
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const ex = dist*cp*sy, ey = dist*sp, ez = -dist*cp*cy;  // eye (units of b)
  // lookAt(eye, 0, up) * perspective, column-major
  const zx=ex, zy=ey, zz=ez, zl=Math.hypot(zx,zy,zz);
  const Z=[zx/zl, zy/zl, zz/zl];
  const X=[Z[2], 0, -Z[0]]; const xl=Math.hypot(X[0],X[1],X[2])||1;
  X[0]/=xl; X[1]/=xl; X[2]/=xl;
  const Y=[Z[1]*X[2]-Z[2]*X[1], Z[2]*X[0]-Z[0]*X[2], Z[0]*X[1]-Z[1]*X[0]];
  const s = 1.0 / bound;   // world -> unit box
  const tx=-(X[0]*ex+X[1]*ey+X[2]*ez), ty=-(Y[0]*ex+Y[1]*ey+Y[2]*ez),
        tz=-(Z[0]*ex+Z[1]*ey+Z[2]*ez);
  const p00=f/a, p11=f, p22=(zf+zn)/(zn-zf), p23=-1, p32=2*zf*zn/(zn-zf);
  // mvp = P * V * S  (S scales index coords by 1/bound)
  return new Float32Array([
    s*(p00*X[0]), s*(p11*Y[0]), s*(p22*Z[0]), s*(p23*Z[0]),
    s*(p00*X[1]), s*(p11*Y[1]), s*(p22*Z[1]), s*(p23*Z[1]),
    s*(p00*X[2]), s*(p11*Y[2]), s*(p22*Z[2]), s*(p23*Z[2]),
    p00*tx,       p11*ty,       p22*tz + p32, p23*tz,
  ]);
}
function draw(){
  canvas.width = innerWidth; canvas.height = innerHeight;
  gl.viewport(0, 0, canvas.width, canvas.height);
  gl.clearColor(0.06, 0.08, 0.10, 1); gl.clear(gl.COLOR_BUFFER_BIT);
  gl.uniformMatrix4fv(loc.mvp, false, mat());
  gl.uniform3f(loc.clip, +cx.value, +cy.value, +cz.value);
  gl.uniform1f(loc.b, bound);
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.enableVertexAttribArray(loc.p);
  gl.vertexAttribPointer(loc.p, 4, gl.FLOAT, false, 0, 0);
  gl.drawArrays(gl.POINTS, 0, npts);
}
async function load(i){
  const r = await fetch('/frame/' + i);
  const ab = await r.arrayBuffer();
  const f = new Float32Array(ab);
  npts = f.length / 4;
  gl.bindBuffer(gl.ARRAY_BUFFER, buf);
  gl.bufferData(gl.ARRAY_BUFFER, f, gl.STATIC_DRAW);
  fi = i;
  document.getElementById('fi').textContent = i;
  document.getElementById('stats').textContent = npts + ' points';
  window.viewerReady = true;     // automation hook
  draw();
}
(async () => {
  const info = await (await fetch('/info')).json();
  frames = info.frames; bound = info.bound;
  document.getElementById('fn').textContent = frames.length - 1;
  document.getElementById('title').textContent = info.title;
  await load(0);
})();
let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if(!drag) return;
  yaw += (e.clientX - drag[0]) * 0.008;
  pitch = Math.max(-1.5, Math.min(1.5, pitch + (e.clientY - drag[1]) * 0.008));
  drag = [e.clientX, e.clientY]; draw(); };
canvas.onwheel = e => { dist = Math.max(1.2, Math.min(10, dist * (e.deltaY > 0 ? 1.1 : 0.9))); draw(); e.preventDefault(); };
for (const id of ['cx','cy','cz']) document.getElementById(id).oninput = draw;
window.onresize = draw;
window.onkeydown = e => {
  if (e.key === ' ') playing = !playing;
  if (e.key === '.') load(Math.min(fi + 1, frames.length - 1));
  if (e.key === ',') load(Math.max(fi - 1, 0));
};
setInterval(() => { if (playing && frames.length)
  load((fi + 1) % frames.length); }, 120);
</script></body></html>
"""


def _frame_points(path: str, max_points: int = 400_000) -> np.ndarray:
    """(K, 4) float32 (x, y, z, normalized value) for one frame file."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            pos = np.asarray(z["pos"] if "pos" in z else z[z.files[0]],
                             np.float32)
        val = np.ones((pos.shape[0], 1), np.float32)
        pts = np.concatenate([pos[:, :3], val], axis=1)
    else:
        from fluidsim_tpu_torch.io.vdb import read_vdb

        grids = read_vdb(path)
        rows = []
        for g in grids:
            act = (g.active if g.active is not None
                   else np.ones(g.values.shape[:3], bool))
            idx = np.argwhere(act).astype(np.float32)
            if not len(idx):
                continue
            idx += np.asarray(g.origin, np.float32)
            v = g.values[act]
            if v.ndim > 1:                     # Vec3 grid: magnitude
                v = np.linalg.norm(v, axis=-1)
            vmax = float(np.max(np.abs(v))) or 1.0
            rows.append(np.concatenate(
                [idx, (np.abs(v) / vmax)[:, None].astype(np.float32)],
                axis=1))
        pts = (np.concatenate(rows, axis=0) if rows
               else np.zeros((0, 4), np.float32))
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points,
                                              replace=False)
        pts = pts[sel]
    return np.ascontiguousarray(pts, np.float32)


class _Handler(BaseHTTPRequestHandler):
    files: list = []
    bound: float = 1.0
    cache: dict = {}

    def log_message(self, *a):                 # quiet
        pass

    def _send(self, code, ctype, body, gz=False):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        if gz:
            self.send_header("Content-Encoding", "gzip")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            self._send(200, "text/html", _PAGE.encode())
        elif self.path == "/info":
            body = json.dumps({
                "frames": list(range(len(self.files))),
                "bound": self.bound,
                "title": (os.path.basename(self.files[0])
                          + f" (+{len(self.files) - 1} more)"
                          if self.files else "no files"),
            }).encode()
            self._send(200, "application/json", body)
        elif self.path.startswith("/frame/"):
            try:
                i = int(self.path.split("/")[-1])
                path = self.files[i]
            except (ValueError, IndexError):
                self._send(404, "text/plain", b"no such frame")
                return
            # ThreadingHTTPServer handles each request on its own thread:
            # compute under the lock (serializes frame encoding, which is
            # fine — it also prevents double-computing the same frame) and
            # evict least-recently-used so playback scrubbing stays warm.
            with self.cache_lock:
                if i in self.cache:
                    body = self.cache.pop(i)       # re-insert → most recent
                else:
                    body = gzip.compress(_frame_points(path).tobytes(), 1)
                self.cache[i] = body
                while len(self.cache) > 8:         # bound memory, LRU out
                    self.cache.pop(next(iter(self.cache)))
            self._send(200, "application/octet-stream", body, gz=True)
        else:
            self._send(404, "text/plain", b"not found")


def serve(files, port: int = 8611, bound: float | None = None,
          block: bool = True):
    """Start the viewer server on ``port``; returns the server object.

    ``bound``: half-width of the index-space box for camera framing;
    inferred from the first frame when omitted."""
    files = [f for f in files if os.path.exists(f)]
    if not files:
        raise FileNotFoundError("no viewable files")
    if bound is None:
        pts = _frame_points(files[0])
        bound = float(np.max(np.abs(pts[:, :3]))) if len(pts) else 1.0
    handler = type("H", (_Handler,), {
        "files": files, "bound": bound, "cache": {},
        "cache_lock": threading.Lock()})
    srv = ThreadingHTTPServer(("127.0.0.1", port), handler)
    print(f"viewer: http://127.0.0.1:{port}/  ({len(files)} frame(s), "
          f"bound {bound:g}) — Ctrl-C to stop")
    if block:
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.server_close()
    else:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
    return srv
