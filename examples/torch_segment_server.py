"""Serve arbitrary PCM segments from an ACM corpus over HTTP (PyTorch
port).

    python examples/torch_segment_server.py CORPUS_DIR [--port 8080] \
        [--index-dir /var/cache/acm-index] [--device DEVICE]

    GET /files                      -> JSON manifest (id, path, frames, rate)
    GET /pcm?file=3&start=44100&n=22050 -> raw s16le frames (interleaved)

A minimal demonstration of the serving stack the reference library cannot
express (its acm_seek_pcm re-decodes from the stream start on every
backward seek, util.c:214-253):

- O(segment) random access via per-block bit-offset indexes
  (`parallel.RandomAccessCorpus`), built lazily, one scan per file EVER
  when `--index-dir` persists them (8 bytes/block `.abix` blobs);
- bounded memory: file bytes live in a small LRU, so a 10k-file corpus
  never accumulates in RSS;
- thread safety: the stdlib ThreadingHTTPServer drives concurrent reads
  straight into the corpus object (cache admission/eviction is locked).

Segments are synthesized on `--device` (default: the card, or
$LIBACM_TPU_TORCH_DEVICE) and fetched for the response.

Run with no CORPUS_DIR to self-demo against the repo's test fixtures.
"""

import argparse
import json
import pathlib
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from libacm_tpu_torch.parallel import RandomAccessCorpus, decode_corpus
from libacm_tpu_torch.stream import acm_open_file


def build_app(paths, index_dir=None, device=None):
    corpus = RandomAccessCorpus([str(p) for p in paths],
                                index_dir=index_dir, device=device)
    manifest = []
    for i, p in enumerate(paths):
        acm = acm_open_file(str(p), device=device)
        manifest.append({"id": i, "path": p.name,
                         "frames": acm.pcm_total(),
                         "rate": acm.rate, "channels": acm.channels})
        acm.close()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/files":
                body = json.dumps(manifest).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if u.path == "/pcm":
                q = parse_qs(u.query)
                try:
                    i = int(q["file"][0])
                    start = int(q.get("start", ["0"])[0])
                    n = int(q["n"][0])
                    if not 0 <= i < len(manifest):
                        raise ValueError(f"file id out of range: {i}")
                    frames = corpus.read(i, start, n)
                except (KeyError, ValueError, IndexError) as exc:
                    self.send_error(400, str(exc))
                    return
                body = frames.tobytes()  # s16le interleaved
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("X-Frames", str(len(frames)))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_error(404)

    return corpus, manifest, Handler


def self_demo(device=None):
    """Exercise the server end-to-end against the test fixtures and check
    every served segment against a full decode."""
    import numpy as np
    import urllib.request

    fixtures = pathlib.Path(__file__).parent.parent / "tests" / "fixtures"
    paths = sorted(fixtures.glob("*.acm"))[:4]
    full = {i: r.pcm for i, r in enumerate(decode_corpus(
        [str(p) for p in paths], device=device))}
    corpus, manifest, handler = build_app(paths, device=device)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    files = json.loads(urllib.request.urlopen(f"{base}/files").read())
    assert len(files) == len(paths)
    for f in files:
        ch = f["channels"]
        start, n = f["frames"] // 3, min(1000, f["frames"] // 2)
        raw = urllib.request.urlopen(
            f"{base}/pcm?file={f['id']}&start={start}&n={n}").read()
        got = np.frombuffer(raw, np.int16).reshape(-1, ch)
        want = full[f["id"]][start * ch:(start + len(got)) * ch]
        assert np.array_equal(got.reshape(-1), want), f["path"]
        print(f"  {f['path']}: {len(got)} frames @ {start} OK")
    srv.shutdown()
    print(f"self-demo OK ({len(files)} files served and verified)")


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("corpus_dir", nargs="?", type=pathlib.Path)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--index-dir", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.corpus_dir is None:
        self_demo(args.device)
        return 0
    paths = sorted(p for p in args.corpus_dir.iterdir()
                   if p.suffix.lower() in (".acm", ".wavc"))
    corpus, manifest, handler = build_app(paths, args.index_dir, args.device)
    srv = ThreadingHTTPServer(("0.0.0.0", args.port), handler)
    print(f"serving {len(manifest)} files on :{args.port} "
          f"(GET /files, /pcm?file=I&start=S&n=N)")
    srv.serve_forever()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
