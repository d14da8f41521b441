"""Avatar reenactment service (counterpart of `app.py`).

    python -m guava_renderer_tpu_torch.cli.app -m <model dir or config>
        [--synthetic_assets] [--port 7860] [--device cuda|cpu]
    python -m guava_renderer_tpu_torch.cli.app -m ... --no_ui \\
        --source_path <tracked dir> --target_path <tracked dir>

Galleries of pre-tracked source images and driving videos, uploads that
shell out to EHM-Tracker when it is installed (ref: app.py:122,143), and
generation on a worker thread in this process with status polling
(ref: app.py:49-75): one process owns the card and reuses its runtime
across requests. The web UI is the dependency-free `http.server` one
(`build_stdlib_app`); the JAX package's Gradio UI is not ported. `--no_ui`
runs one generation and polls it.

`check_status` returns a video only when its job is "done", or, for a pair
no job of this process knows, when the file exists (a result of an earlier
run, as `submit` treats one). The job is "done" once `render_cross_set` has
returned, and `utils/video.py` renames the file into place only when it is
whole. (The JAX package returns the video as soon as the file exists, which
`cv2.VideoWriter` creates when it opens it, so a poll may see a file still
being written.)
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

OUTNAME = "render"
EHM_TRACKER_DIR = "EHM-Tracker"
TRACKED_IMG_DIR = "assets/example/tracked_image"
TRACKED_VID_DIR = "assets/example/tracked_video"


def list_tracked(root: str) -> list[tuple[str | None, str]]:
    """Gallery entries (preview_image_or_None, caption) for tracked dirs."""
    items = []
    if not os.path.isdir(root):
        return items
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        preview = None
        for cand in ("preview.jpg", "preview.png", "source.jpg", "source.png"):
            p = os.path.join(d, cand)
            if os.path.exists(p):
                preview = p
                break
        items.append((preview, name))
    return items


def track_upload(upload_path: str, out_dir: str, video: bool) -> str:
    """Shell out to EHM-Tracker for an uploaded image/video
    (ref: app.py:122,143). Requires the external tracker checkout."""
    name = os.path.splitext(os.path.basename(upload_path))[0]
    dst = os.path.join(out_dir, name)
    if os.path.exists(os.path.join(dst, "optim_tracking_ehm.pkl")):
        return dst  # tracked before (ref: app.py:117-119)
    if not os.path.isdir(EHM_TRACKER_DIR):
        raise RuntimeError(
            f"'{EHM_TRACKER_DIR}' not found — uploads need the external "
            "EHM-Tracker (github.com/Pixel-Talk/EHM-Tracker); use the "
            "pre-tracked gallery items instead")
    module = "src.tracking_video" if video else "src.tracking_single_image"
    subprocess.run(
        [sys.executable, "-m", module, "-i", os.path.abspath(upload_path),
         "-o", os.path.abspath(out_dir)],
        cwd=EHM_TRACKER_DIR, check=True)
    return dst


class GenerationService:
    """Serialized in-process generation with status polling.

    One worker thread at a time owns the device: requests queue behind a
    lock. `args` carries model_path, synthetic_assets, allow_random_weights,
    save_dir, max_frames and device (default "cuda")."""

    def __init__(self, args):
        from ..device import resolve_device

        self.args = args
        self.device = resolve_device(getattr(args, "device", "cuda"))
        self.lock = threading.Lock()
        self._jobs_lock = threading.Lock()
        self._rt = None
        self._params = None
        self.jobs: dict[str, dict] = {}

    def _runtime(self):
        if self._rt is None:
            from .context import build_runtime, load_model_params, resolve_config

            cfg = resolve_config(self.args.model_path)
            self._rt = build_runtime(cfg, synthetic_assets=self.args.synthetic_assets,
                                     device=self.device)
            self._params, src = load_model_params(
                self._rt, self.args.model_path,
                allow_random=self.args.allow_random_weights or self.args.synthetic_assets)
            print(f"[app] weights: {src}")
        return self._rt, self._params

    def output_path(self, src_name: str, dst_name: str) -> str:
        return os.path.join(self.args.save_dir, f"{OUTNAME}_cross_act", src_name,
                            f"{src_name}_{dst_name}", "cross_reenact.mp4")

    def submit(self, source_dir: str, target_dir: str) -> str:
        src_name = os.path.basename(os.path.normpath(source_dir))
        dst_name = os.path.basename(os.path.normpath(target_dir))
        key = f"{src_name}_{dst_name}"
        out_mp4 = self.output_path(src_name, dst_name)
        with self._jobs_lock:
            state = self.jobs.get(key, {}).get("state")
            if state == "running" or (state != "failed" and os.path.exists(out_mp4)):
                return key
            self.jobs[key] = {"state": "running", "error": None}
        t = threading.Thread(target=self._run, args=(key, source_dir, target_dir, out_mp4),
                             daemon=True)
        t.start()
        return key

    def _run(self, key, source_dir, target_dir, out_mp4):
        try:
            with self.lock:
                from ..data.tracked import TrackedVideoDataset
                from .inference import render_cross_set

                rt, params = self._runtime()
                cfg = rt.cfg

                def ds(path):
                    return TrackedVideoDataset(
                        path, "test",
                        image_size=cfg.MODEL.image_size,
                        feature_img_size=cfg.MODEL.feature_img_size,
                        origin_image_size=cfg.DATASET.origin_image_size)

                render_cross_set(rt, params, ds(source_dir), ds(target_dir),
                                 os.path.dirname(out_mp4), max_frames=self.args.max_frames)
            result = {"state": "done", "error": None}
        except Exception as e:  # the worker's boundary: surfaced by check_status
            result = {"state": "failed", "error": f"{type(e).__name__}: {e}"}
        with self._jobs_lock:
            self.jobs[key] = result

    def check_status(self, src_name: str | None, dst_name: str | None):
        """(message, video path or None) (ref: app.py:49-75 master_check_status)."""
        if not src_name:
            return "Please provide a source to check.", None
        if not dst_name:
            return "Please provide a driving video to check.", None
        key = f"{src_name}_{dst_name}"
        out_mp4 = self.output_path(src_name, dst_name)
        with self._jobs_lock:
            job = self.jobs.get(key)
        if job and job["state"] == "failed":
            return f"Generation failed: {job['error']}", None
        ready = job["state"] == "done" if job else True
        if ready and os.path.exists(out_mp4):
            return "Processing completed successfully! 🎉", out_mp4
        return "Still processing... You can check progress again later. ⏳", None


def _resolve_inputs(args, service, source_sel, source_upload, driven_sel, driven_upload):
    """Gallery/upload combinations -> tracked dirs (ref: app.py:78-160)."""
    if source_upload:
        src_dir = track_upload(
            source_upload, os.path.join(args.save_dir, "tracked_source_image"), video=False)
    elif source_sel:
        src_dir = os.path.join(TRACKED_IMG_DIR, source_sel)
    else:
        raise ValueError("Please provide both a source and a driving input.")
    if driven_upload:
        tgt_dir = track_upload(
            driven_upload, os.path.join(args.save_dir, "tracked_driven_video"), video=True)
    elif driven_sel:
        tgt_dir = os.path.join(TRACKED_VID_DIR, driven_sel)
    else:
        raise ValueError("Please provide both a source and a driving input.")
    return src_dir, tgt_dir


_PAGE = """<!doctype html><html><head><title>GUAVA avatar reenactment</title>
<style>
 body{font-family:sans-serif;margin:2em;max-width:1100px}
 .gal{display:flex;flex-wrap:wrap;gap:8px}
 .gal label{border:2px solid #ccc;border-radius:6px;padding:6px;cursor:pointer}
 .gal input:checked+span{font-weight:bold;color:#06c}
 .gal img{display:block;max-width:120px;max-height:120px}
 button{margin:1em 1em 1em 0;padding:.5em 1.5em}
 #status{padding:.5em;background:#f4f4f4;border-radius:4px;min-height:1.2em}
 video{max-width:480px;display:block;margin-top:1em}
 #history{display:flex;gap:8px;flex-wrap:wrap}
</style></head><body>
<h1>GUAVA &mdash; upper-body Gaussian avatar reenactment</h1>
<div style="display:flex;gap:3em">
 <div><h3>Source identity</h3><div class="gal" id="src"></div></div>
 <div><h3>Driving motion</h3><div class="gal" id="vid"></div></div>
</div>
<button id="go">Generate</button><button id="check">Check status</button>
<div id="status">idle</div>
<video id="result" controls></video>
<h3>Generation history</h3><div id="history"></div>
<script>
const sel = {src: null, vid: null};
function gallery(el, kind, items) {
  el.innerHTML = items.map((it, i) =>
    `<label><input type=radio name=${kind} value="${it.name}" hidden>` +
    (it.preview ? `<img src="/media/${it.preview}">` : "") +
    `<span>${it.name}</span></label>`).join("");
  el.querySelectorAll("input").forEach(r =>
    r.addEventListener("change", () => { sel[kind] = r.value; }));
}
async function refresh() {
  const it = await (await fetch("/api/items")).json();
  gallery(document.getElementById("src"), "src", it.sources);
  gallery(document.getElementById("vid"), "vid", it.videos);
}
async function call(ep) {
  if (!sel.src || !sel.vid) {
    document.getElementById("status").textContent =
      "Please provide both a source and a driving input."; return;
  }
  const r = await (await fetch(
    `/api/${ep}?src=${encodeURIComponent(sel.src)}&vid=${encodeURIComponent(sel.vid)}`,
    {method: ep === "generate" ? "POST" : "GET"})).json();
  document.getElementById("status").textContent = r.status;
  if (r.result) {
    document.getElementById("result").src = "/media/" + r.result;
    const h = document.getElementById("history");
    if (![...h.children].some(v => v.dataset.k === r.result)) {
      const v = document.createElement("video");
      v.src = "/media/" + r.result; v.width = 160; v.controls = true;
      v.dataset.k = r.result; h.appendChild(v);
    }
  }
}
document.getElementById("go").onclick = () => call("generate");
document.getElementById("check").onclick = () => call("status");
refresh();
</script></body></html>"""



def build_stdlib_app(args, service: GenerationService):
    """Dependency-free web UI with the reference's flows: tracked galleries,
    generate, check-status polling, per-result history (ref: app.py:216-334).
    Serves from http.server on 127.0.0.1:args.port (0: any free port);
    media paths are whitelisted to the tracked dirs and save_dir."""
    import http.server
    import json as _json
    import urllib.parse

    img_dir = args.tracked_image_dir
    vid_dir = args.tracked_video_dir
    roots = [os.path.realpath(p)
             for p in (img_dir, vid_dir, args.save_dir)]

    def items():
        def pack(root):
            return [
                {"name": c, "preview": os.path.relpath(p) if p else None}
                for p, c in list_tracked(root)
            ]
        return {"sources": pack(img_dir), "videos": pack(vid_dir)}

    class Handler(http.server.BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _job(self):
            q = urllib.parse.parse_qs(urllib.parse.urlparse(self.path).query)
            src = q.get("src", [None])[0]
            vid = q.get("vid", [None])[0]
            return src, vid

        def _status_payload(self, src, vid):
            msg, path = service.check_status(src, vid)
            rel = os.path.relpath(path) if path else None
            return _json.dumps({"status": msg, "result": rel}).encode()

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif path == "/api/items":
                self._send(200, _json.dumps(items()).encode())
            elif path == "/api/status":
                src, vid = self._job()
                self._send(200, self._status_payload(src, vid))
            elif path.startswith("/media/"):
                rel = urllib.parse.unquote(path[len("/media/"):])
                full = os.path.realpath(rel)
                if not any(full.startswith(r + os.sep) or full == r
                           for r in roots) or not os.path.isfile(full):
                    self._send(404, b"{}")
                    return
                ctype = ("video/mp4" if full.endswith(".mp4")
                         else "image/png" if full.endswith(".png")
                         else "image/jpeg")
                with open(full, "rb") as f:
                    self._send(200, f.read(), ctype)
            else:
                self._send(404, b"{}")

        def do_POST(self):
            path = urllib.parse.urlparse(self.path).path
            if path != "/api/generate":
                self._send(404, b"{}")
                return
            src, vid = self._job()
            if not src or not vid:
                self._send(200, _json.dumps({
                    "status": "Please provide both a source and a driving input.",
                    "result": None}).encode())
                return
            service.submit(os.path.join(img_dir, src), os.path.join(vid_dir, vid))
            self._send(200, self._status_payload(src, vid))

        def log_message(self, fmt, *a):  # quiet
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"[app] stdlib UI on http://127.0.0.1:{httpd.server_address[1]}")
    return httpd


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model_path", "-m", type=str, default="assets/GUAVA")
    parser.add_argument("--source_path", type=str, default=None)
    parser.add_argument("--target_path", type=str, default=None)
    parser.add_argument("--save_dir", type=str, default="outputs/app")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--synthetic_assets", action="store_true")
    parser.add_argument("--allow_random_weights", action="store_true")
    parser.add_argument("--max_frames", type=int, default=None)
    parser.add_argument("--no_ui", action="store_true",
                        help="run one generation without the web UI")
    parser.add_argument("--tracked_image_dir", default=TRACKED_IMG_DIR)
    parser.add_argument("--tracked_video_dir", default=TRACKED_VID_DIR)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser


def main(argv=None, poll_s: float = 5.0):
    args = build_parser().parse_args(argv)
    service = GenerationService(args)
    if not args.no_ui:
        build_stdlib_app(args, service).serve_forever()
        return None
    if not (args.source_path and args.target_path):
        raise SystemExit("--no_ui needs --source_path and --target_path")
    key = service.submit(args.source_path, args.target_path)
    src = os.path.basename(os.path.normpath(args.source_path))
    dst = os.path.basename(os.path.normpath(args.target_path))
    while True:
        msg, path = service.check_status(src, dst)
        print(msg)
        if path or service.jobs.get(key, {}).get("state") == "failed":
            break
        time.sleep(poll_s)
    if path:
        print(f"result: {path}")
    return path


if __name__ == "__main__":
    main()
