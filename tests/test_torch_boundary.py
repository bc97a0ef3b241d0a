"""The port's package boundary.

The port imports torch, never jax and nothing of libacm_tpu; the host
layers it shares with the JAX package are byte-identical copies, which
keeps the two scanners (and their oracle) in lockstep. The probe drives
the corpus (one device and a device list), stream, stream-device,
distributed, random-access and CLI surfaces and the unpack kernel's
wrapper (ops/unpack_cuda.py, on a CPU blob) in a fresh process, imports
the encoder, ingest and profiling modules, the port's examples, entry
file, card tools, chip_smoke.py and bench_torch.py, runs the entry file's
dry run and the bench's CPU rehearsal (`--device cpu --scale 0.02`), then
checks what was loaded.
"""

import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = textwrap.dedent("""
    import sys
    import numpy as np
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import decode_corpus, decode_corpus_device

    rng = np.random.default_rng(1)
    files = [testing.random_acm_bytes(rng, level=4, rows=8, n_blocks=3),
             testing.random_acm_bytes(rng, level=2, rows=1, n_blocks=4)]
    dc = decode_corpus_device(files, device="cpu")
    res = dc.to_results()
    assert all(r.ok for r in res) and dc.checksum() >= 0
    assert len(decode_corpus(files, device="cpu")) == 2

    import contextlib, io, pathlib
    from libacm_tpu_torch import acm_open_file, cli, encode, ingest
    from libacm_tpu_torch.parallel import build_index, read_segment
    from libacm_tpu_torch.utils import profiling

    fx = pathlib.Path("tests/fixtures/speech_22k_mono.acm")
    s = acm_open_file(fx, device="cpu")
    head = s.read_loop(5000)
    assert s.seek_pcm(1000) == 1000 and s.read_loop(200)
    assert s.seek_pcm(0) == 0 and s.read_loop(5000) == head
    data = fx.read_bytes()
    seg = read_segment(data, build_index(data), 300, 700, device="cpu")
    assert seg.tobytes() == head[600:2000]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(["-i", str(fx)]) == 0
    assert "A:7/16" in out.getvalue()
    assert encode.encode_pcm and ingest.iter_pcm and profiling.trace

    import torch
    from libacm_tpu_torch.ops import synth_torch, unpack_cuda
    assert unpack_cuda.unpack_launches(7, 1, 8, True)
    blob = torch.zeros(synth_torch.cols_blob_layout(3, 1, 2, (0,) * 6)[1],
                       dtype=torch.uint8)
    k, vals, w0 = unpack_cuda.unpack_cols_blob(
        blob, level=3, rows=4, batch=1, nb=2, lens=(0,) * 6, has_wrap=True)
    assert k.shape == (1, 2, 4, 8) and not k.any() and w0.shape == (1, 14)

    from libacm_tpu_torch.parallel import (decode_stream_device, distributed,
                                           make_mesh, shard_manifest)
    sharded = decode_corpus_device(files, devices=["cpu"] * 3)
    assert sharded.checksum() == dc.checksum()
    spans, meta = decode_stream_device(files[0], devices=["cpu", "cpu"],
                                       window_blocks=2)
    assert meta.status == 0 and len(spans) == 3
    distributed.initialize()
    assert shard_manifest(files) == files
    assert distributed.allreduce_summary(dc.summary) is dc.summary

    import importlib.util
    for rel in ("examples/torch_transcode_corpus.py",
                "examples/torch_stream_player.py",
                "examples/torch_training_ingest.py",
                "examples/torch_segment_server.py",
                "tools/torch_parity_sweep.py", "tools/torch_synth_ab.py",
                "tools/torch_synth_probe.py", "tools/torch_rss_sweep.py",
                "tools/torch_multicard_check.py", "tools/torch_unpack_ab.py",
                "tools/torch_unpack_probe.py",
                "chip_smoke.py", "bench_torch.py",
                "__graft_entry_torch__.py"):
        spec = importlib.util.spec_from_file_location(
            pathlib.Path(rel).stem, rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    mod.dryrun_multidevice(["cpu", "cpu"])

    # the bench's rehearsal, end to end in this process
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert sys.modules["bench_torch"].main(
            ["--device", "cpu", "--scale", "0.02", "--repeats", "1"]) == 0
    assert '"rehearsal": true' in out.getvalue()
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "libacm_tpu")
                 or m.startswith(("jax.", "libacm_tpu.")))
    print("LOADED", bad)
    sys.exit(1 if bad else 0)
""")


def test_port_decodes_without_jax_or_the_jax_package():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout


@pytest.mark.parametrize("rel", ["format.py", "io.py", "scan/oracle.py",
                                 "scan/_scan.cpp", "testing.py"])
def test_shared_host_layers_are_byte_identical(rel):
    assert ((ROOT / "libacm_tpu_torch" / rel).read_bytes()
            == (ROOT / "libacm_tpu" / rel).read_bytes())
