"""bench_torch.py's harness, on the CPU: the one-line contract under an
exception and under SIGTERM, the idempotent emit, the in-turns scheduler and
its statistics, the parity-sweep parser, the CPU rehearsal end to end, the
refusal to run without a card, and the pinned bytes of make_corpus.

In the manner of tests/test_bench_harness.py: the module is loaded from its
path. Whether there is a card is decided inside tests (here: patched away),
never at import. Every subprocess has a time limit.
"""

import hashlib
import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
_BENCH = ROOT / "bench_torch.py"

#: SHA-256 over make_corpus(testing, 0.02)'s files, each behind its length:
#: the bytes the bench and chip_smoke.py decode must not drift, or numbers
#: stop being comparable between PRs
CORPUS_SHA256_AT_0_02 = (
    "6ded8b9b5725838d89366d4e582973ac2833f40e056c1592d6198ee7ce70c845")
#: SHA-256 of long_stream(seed STREAM_SEED) at scaled_stream_shape(0.02)
STREAM_SHA256_AT_0_02 = (
    "e0896492d666f46b705e23557540fc9f7011a3d86375326b9419c2ad2c212731")


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _load("bench_torch_under_test", _BENCH)


@pytest.fixture
def fresh(bench, monkeypatch):
    """The bench module with no artifact set and none emitted."""
    monkeypatch.setattr(bench, "_ARTIFACT", None)
    monkeypatch.setattr(bench, "_EMITTED", False)
    monkeypatch.setattr(bench, "_install_artifact_guard", lambda: None)
    return bench


def _corpus_digest(files) -> str:
    """SHA-256 over the corpus's files, each behind its length."""
    h = hashlib.sha256()
    for data in files:
        h.update(len(data).to_bytes(8, "little"))
        h.update(data)
    return h.hexdigest()


def _lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.strip()]


# -- the one-line contract ----------------------------------------------------


def test_emit_artifact_is_idempotent(fresh, capsys):
    fresh.emit_artifact()  # nothing set yet: no output
    assert capsys.readouterr().out == ""
    fresh.set_artifact({"metric": "m", "value": 1})
    fresh.emit_artifact()
    fresh.emit_artifact()  # second call must not print a second line
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and '"value": 1' in out


def test_emit_refuses_nan(fresh):
    fresh.set_artifact({"metric": "m", "value": float("nan")})
    with pytest.raises(ValueError):
        fresh.emit_artifact()


def test_crash_before_first_artifact_prints_no_line(fresh, monkeypatch,
                                                    capsys):
    """An exception before the first pair is measured: no line, non-zero
    exit, and nothing measured in its place."""
    def boom(*a, **k):
        raise RuntimeError("make_corpus exploded")

    monkeypatch.setattr(fresh, "run_bench", boom)
    rc = fresh.main(["--device", "cpu", "--scale", "0.02"])
    assert rc != 0
    assert _lines(capsys.readouterr().out) == []


def test_crash_after_first_artifact_emits_it_marked(fresh, monkeypatch,
                                                    capsys):
    """An exception after the first secured artifact: exactly one line,
    marked "crashed", and a non-zero exit."""
    def run_bench(device, repeats, scale, seed, *, deadline, on_first):
        on_first({"metric": "corpus_decode_Msamples_per_s", "value": 5.0,
                  "headline_path": "device"})
        raise ValueError("stream arm differs")

    monkeypatch.setattr(fresh, "run_bench", run_bench)
    rc = fresh.main(["--device", "cpu", "--scale", "0.02"])
    assert rc != 0
    lines = _lines(capsys.readouterr().out)
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["value"] == 5.0 and d["headline_path"] == "device"
    assert d["crashed"] == "ValueError: stream arm differs"


def test_clean_run_emits_one_line_and_exits_zero(fresh, monkeypatch, capsys):
    monkeypatch.setenv("LIBACM_TPU_TORCH_BENCH_BUDGET_S", "50")
    seen = {}

    def run_bench(device, repeats, scale, seed, *, deadline, on_first):
        import time

        seen.update(device=device, repeats=repeats, scale=scale, seed=seed,
                    budget=deadline - time.time())
        art = {"metric": "m", "value": 1.0}
        on_first(art)
        return art

    monkeypatch.setattr(fresh, "run_bench", run_bench)
    assert fresh.main(["--device", "cpu", "--repeats", "2", "--scale",
                       "0.5", "--seed", "9"]) == 0
    assert len(_lines(capsys.readouterr().out)) == 1
    assert (seen["device"], seen["repeats"], seen["scale"],
            seen["seed"]) == ("cpu", 2, 0.5, 9)
    assert 40 < seen["budget"] <= 50


def test_sigterm_flushes_artifact(tmp_path):
    """An external killer must flush the secured artifact: exactly one
    JSON line on stdout, marked interrupted, exit 0."""
    script = tmp_path / "guarded.py"
    script.write_text(
        "import importlib.util, sys, time\n"
        f"spec = importlib.util.spec_from_file_location('b', {str(_BENCH)!r})\n"
        "b = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(b)\n"
        "b._install_artifact_guard()\n"
        "b.set_artifact({'metric': 'm', 'value': 7})\n"
        "print('READY', file=sys.stderr, flush=True)\n"
        "time.sleep(120)\n"  # a stalled later group
    )
    proc = subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stderr.readline().strip() == "READY"
        os.kill(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0
    lines = _lines(out)
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["value"] == 7 and d["interrupted"] == f"signal {signal.SIGTERM}"


def test_atexit_flushes_a_secured_artifact(tmp_path):
    """A clean exit that never reached the normal emit still prints the
    line once."""
    script = tmp_path / "exiting.py"
    script.write_text(
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('b', {str(_BENCH)!r})\n"
        "b = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(b)\n"
        "b._install_artifact_guard()\n"
        "b.set_artifact({'metric': 'm', 'value': 3})\n"
        "sys.exit(4)\n"
    )
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 4
    assert [json.loads(ln)["value"] for ln in _lines(r.stdout)] == [3]


# -- no card ------------------------------------------------------------------


def test_no_card_and_no_device_flag_exits_nonzero_without_a_line(
        fresh, monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **k):
        raise AssertionError("nothing may be measured without a card")

    monkeypatch.setattr(fresh, "run_bench", never)
    for argv in ([], ["--device", "cuda"], ["--scale", "0.02"]):
        assert fresh.main(argv) != 0
    captured = capsys.readouterr()
    assert _lines(captured.out) == []
    assert "--device cpu" in captured.err


@pytest.mark.parametrize("argv", [["--repeats", "0"], ["--scale", "0"],
                                  ["--scale", "1.5"], ["--device", "tpu"]])
def test_bad_arguments_are_refused(fresh, argv, capsys):
    with pytest.raises(SystemExit) as e:
        fresh.main(argv)
    assert e.value.code != 0
    assert _lines(capsys.readouterr().out) == []


# -- arms in turns ------------------------------------------------------------


def test_turn_order_is_a_b_b_a(bench):
    assert bench.turn_order(2, 4) == [[0, 1], [1, 0], [0, 1], [1, 0]]
    assert bench.turn_order(3, 2) == [[0, 1, 2], [2, 1, 0]]
    assert bench.turn_order(2, 1) == [[0, 1]]


def test_run_in_turns_schedule_and_statistics(bench):
    """Injected times: the scheduler runs warm-up A, B then A, B, B, A, ...
    and the medians, min, max and per-turn ratio come out right."""
    calls: list[str] = []
    # seconds each call takes, in call order, by arm
    script = {"A": iter([9.0, 1.0, 2.0, 4.0]), "B": iter([9.0, 2.0, 2.0, 2.0])}
    now = [0.0]
    synced: list[float] = []
    values: list[tuple] = []

    def arm(name):
        def fn():
            calls.append(name)
            now[0] += next(script[name])
            return name.lower()
        return fn

    t = bench.run_in_turns(
        [("A", arm("A")), ("B", arm("B"))], 3, warmup=1,
        sync=lambda: synced.append(now[0]),
        on_result=lambda n, v: values.append((n, v)), clock=lambda: now[0])
    assert calls == ["A", "B", "A", "B", "B", "A", "A", "B"]
    assert t == {"A": [1.0, 2.0, 4.0], "B": [2.0, 2.0, 2.0]}
    assert len(synced) == 2 * len(calls)  # before the clock starts and stops
    assert values == [(c, c.lower()) for c in calls]
    a = bench.summarize(t["A"], 8.0)
    assert a == {"median": 4.0, "min": 2.0, "max": 8.0,
                 "runs": [8.0, 4.0, 2.0]}
    assert bench.summarize(t["B"], 8.0)["median"] == 4.0
    # A's rate over B's, round by round: 2, 1, 0.5
    assert bench.turn_ratio(t["A"], t["B"]) == 1.0
    assert bench.turn_ratio([1.0, 1.0, 4.0], [2.0, 3.0, 4.0]) == 2.0


def test_run_in_turns_stops_at_the_deadline_after_one_round(bench):
    calls = []
    t = bench.run_in_turns([("A", lambda: calls.append("A")),
                            ("B", lambda: calls.append("B"))], 5, warmup=0,
                           deadline=0.0)  # long past
    assert calls == ["A", "B"]  # one full round, then no more
    assert len(t["A"]) == len(t["B"]) == 1


def test_device_compute_is_share_weighted_harmonic_mean(bench):
    rows = [{"path": "corpus", "level": 7, "rows": 16,
             "Msamples_per_s": 150.0},
            {"path": "corpus", "level": 4, "rows": 40,
             "Msamples_per_s": 80.0},
            {"path": "stream_window_2048", "level": 7, "rows": 16,
             "Msamples_per_s": 1.0}]  # not a corpus row: left out
    got = bench.device_compute_msps(rows, {(7, 16): 3_000_000,
                                           (4, 40): 1_000_000})
    want = 4_000_000 / (3_000_000 / 150.0 + 1_000_000 / 80.0)
    assert abs(got - want) < 1e-9
    assert bench.device_compute_msps([], {}) is None


def test_bound_says_what_bounds_it(bench):
    ms, by = bench.bound(7, 16, 25, 320)
    assert by == "bytes" and abs(ms - 0.0195877) < 1e-6
    assert bench.bound(10, 4, 10, 160)[1] == "operations"
    assert bench.bound(0, 2048, 5, 416)[1] == "bytes"


@pytest.mark.parametrize("nb,rows,cols", [(50, 3, 5), (130, 16, 128)])
def test_block_unpack_bound_reads_no_padding_payload(bench, nb, rows, cols):
    """unpack_blocks_bound counts the payload of the packed rows that name
    a block, the index arrays and k once; a padding row (idx == nb) adds
    its 4-byte index and none of its payload, which the kernel never
    reads."""
    import numpy as np

    from libacm_tpu_torch.ops import packing

    rng = np.random.default_rng(nb)
    n = rows * cols
    k = np.zeros((nb, n), np.int16)
    for i in range(nb):
        s = int(rng.choice([8, 128, 32768]))
        k[i] = rng.integers(-s, s, n)
    k = k.reshape(nb, rows, cols)
    c4, c8, c16 = packing.class_counts(k)
    assert min(c4, c8, c16) > 0
    want = c4 * ((n + 1) // 2) + c8 * n + c16 * 2 * n + 4 * nb + 2 * nb * n
    ms, by = bench.unpack_blocks_bound(packing.pack_blocks(k))
    assert by == "bytes"
    assert ms == pytest.approx(want / bench.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    pads = tuple(-(-c // 64) * 64 for c in (c4, c8, c16))
    padded = packing.pack_blocks(k, pad_to=pads)
    n_pad = sum(pads) - nb
    assert n_pad > 0
    ms_pad, _ = bench.unpack_blocks_bound(padded)
    assert ms_pad == pytest.approx(
        (want + 4 * n_pad) / bench.HBM_BYTES_PER_S * 1e3, rel=1e-12)
    hbm = bench.HBM_BYTES_PER_S
    assert ms_pad < (padded.wire_bytes + 2 * nb * n) / hbm * 1e3


def test_block_unpack_bound_reads_each_owner_row_once(bench):
    """The bound counts one payload a named block, after the JAX index
    rules: a negative idx wraps, one past the wrap's range names nothing,
    and of rows naming one block only the latest class's is read."""
    import numpy as np

    from libacm_tpu_torch.ops import packing

    n, nb = 8, 6
    pk = packing.PackedBlocks(
        nb=nb, rows=2, cols=4, p4=np.zeros((3, 4), np.int8),
        p8=np.zeros((2, n), np.int8), p16=np.zeros((2, n), np.int16),
        idx4=np.array([0, 1, -7], np.int32),  # -7 wraps to block 0
        idx8=np.array([1, -1], np.int32),  # -1: row nb, dropped
        idx16=np.array([2, 9], np.int32))  # 9: past nb, dropped
    # block 0: the 4-bit row (twice); block 1: the 8-bit row; block 2: 16
    want = 4 + n + 2 * n + 4 * 7 + 2 * nb * n
    ms, by = bench.unpack_blocks_bound(pk)
    assert by == "bytes"
    assert ms == pytest.approx(want / bench.HBM_BYTES_PER_S * 1e3, rel=1e-12)


def test_profiled_keeps_only_a_window_that_recorded_a_spin_kernel(
        bench, monkeypatch):
    """profiled runs fn again while a window recorded none of its spin
    kernels (the profiler may have lost fn's first activities too), keeps
    the first window that did, leaves the spin kernels and host events
    out, and returns no counts after PROFILE_TRIES windows without one."""
    import types

    import torch.profiler
    from torch.autograd import DeviceType

    def ev(key, count, dev=DeviceType.CUDA):
        return types.SimpleNamespace(key=key, count=count, device_type=dev,
                                     self_device_time_total=1000.0 * count)

    windows = []

    class Window:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return windows.pop(0)

    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Window())
    card = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, _sleep=lambda cycles: None))
    calls = []
    windows += [[ev("checksum_kernel", 1)],  # lost its spin kernels
                [ev("spin_kernel", 2), ev("Memcpy HtoD", 1),
                 ev("checksum_kernel", 1), ev("aten::sum", 1, DeviceType.CPU)]]
    _, ranked = bench.profiled(card, lambda: calls.append(1))
    assert len(calls) == 2 and not windows
    assert sorted((c, k) for _, c, k in ranked) == [
        (1, "Memcpy HtoD"), (1, "checksum_kernel")]
    windows += [[ev("checksum_kernel", 1)]] * bench.PROFILE_TRIES
    calls.clear()
    _, ranked = bench.profiled(card, lambda: calls.append(1))
    assert ranked == [] and len(calls) == bench.PROFILE_TRIES


# -- the parity-sweep parser --------------------------------------------------

_OK = "level {lv:2d} rows {rows:4d} {route:11s} {what:14s}: OK\n"


def _level_ok(lv: int, n: int = 4) -> str:
    cases = [(64, "synth_fused", "zero carry"),
             (64, "synth_fused", "non-zero carry"),
             (1, "synth_pass", "zero carry"),
             (1, "synth_pass", "non-zero carry")]
    return "".join(_OK.format(lv=lv, rows=r, route=rt, what=w)
                   for r, rt, w in cases[:n])


def test_parity_sweep_parses_result_lines(bench, monkeypatch):
    """The tool's flushed SWEEP RESULT line is authoritative: PASS,
    clean-deadline PARTIAL, and any MISMATCH -> FAIL."""
    cases = [
        (_level_ok(0) + "SWEEP RESULT: PASS 4 cases over levels 0-0, "
         "routes ['synth_fused', 'synth_pass']\n", 0, "PASS"),
        (_level_ok(0) + _level_ok(1) + "DEADLINE: stopping before level 2\n"
         "SWEEP RESULT: PARTIAL ok=0,1\n", 0,
         "PARTIAL: levels 0,1 OK (deadline)"),
        (_level_ok(0) + "level  1 rows   64 synth_fused zero carry    : "
         "MISMATCH\nSWEEP RESULT: FAIL mismatch=1 of 5\n", 1, "FAIL"),
        # a mismatch line with the result line lost is still a FAIL
        ("level  1 rows   64 synth_fused zero carry    : MISMATCH\n", -9,
         "FAIL"),
    ]
    for out, rc, want in cases:
        monkeypatch.setattr(
            bench.subprocess, "run",
            lambda argv, timeout, capture_output, text, _o=out, _r=rc:
            subprocess.CompletedProcess(argv, _r, stdout=_o, stderr=""))
        assert bench.parity_sweep(300.0, echo=lambda s: None) == want


def test_parity_sweep_salvages_partial_output_on_timeout(bench, monkeypatch):
    """A hard subprocess timeout mid-level salvages the levels whose
    cases all printed into a PARTIAL verdict; a level cut short does not
    count."""
    partial = _level_ok(0) + _level_ok(1) + _level_ok(2, n=3)

    def fake_run(argv, timeout, capture_output, text):
        assert any(a.startswith("--deadline-s=") for a in argv)
        assert argv[1].endswith("tools/torch_parity_sweep.py")
        raise subprocess.TimeoutExpired(argv, timeout, output=partial)

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    assert (bench.parity_sweep(300.0, echo=lambda s: None)
            == "PARTIAL: levels 0,1 OK (timed out mid-level)")

    def fake_run_bytes(argv, timeout, capture_output, text):
        raise subprocess.TimeoutExpired(argv, timeout, output=b"")

    monkeypatch.setattr(bench.subprocess, "run", fake_run_bytes)
    assert bench.parity_sweep(300.0, echo=lambda s: None) == "sweep timed out"


def test_parity_sweep_crash_is_not_a_fail_verdict(bench, monkeypatch):
    """rc != 0 with no mismatch in the output is a crash (no card, an
    import error, a failed build): never the terminal FAIL, never PASS."""
    for rc, out in ((-11, ""), (2, ""), (1, "Traceback ...\n"), (0, "")):
        monkeypatch.setattr(
            bench.subprocess, "run",
            lambda argv, timeout, capture_output, text, _r=rc, _o=out:
            subprocess.CompletedProcess(argv, _r, stdout=_o,
                                        stderr="Segmentation"))
        got = bench.parity_sweep(300.0, echo=lambda s: None)
        assert got == f"error (sweep subprocess crashed, rc={rc})"


def test_sweep_tool_and_bench_agree_on_lines_per_level(bench):
    tool = _load("torch_parity_sweep_under_test",
                 ROOT / "tools" / "torch_parity_sweep.py")
    assert tool.CASES_PER_LEVEL == bench.SWEEP_CASES_PER_LEVEL


def test_sweep_tool_exits_2_without_a_card(monkeypatch, capsys):
    import torch

    tool = _load("torch_parity_sweep_under_test",
                 ROOT / "tools" / "torch_parity_sweep.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["--deadline-s=5", "3"]) == 2
    assert "SWEEP RESULT" not in capsys.readouterr().out


# -- the rehearsal, end to end ------------------------------------------------


@pytest.fixture(scope="module")
def rehearsal():
    """`python3 bench_torch.py --device cpu --scale 0.02` in a fresh
    process; (line as a dict, stdout lines, stderr)."""
    env = dict(os.environ)
    env.pop("LIBACM_TPU_TORCH_DEVICE", None)
    r = subprocess.run(
        [sys.executable, str(_BENCH), "--device", "cpu", "--scale", "0.02",
         "--repeats", "2"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = _lines(r.stdout)
    assert len(lines) == 1
    return json.loads(lines[0]), lines, r.stderr


def test_rehearsal_marks_itself_and_leaves_card_fields_null(bench, rehearsal):
    d, _, _ = rehearsal
    assert d["rehearsal"] is True
    assert d["device"] == {"platform": "cpu", "kind": "cpu", "count": 0,
                           "nvidia_smi": None}
    assert d["headline_path"] == "rehearsal-cpu"
    assert d["metric"] == "corpus_decode_Msamples_per_s"
    assert d["unit"] == "Msamples/s"
    for field in bench.CARD_FIELDS:
        assert field in d and d[field] is None, field
    assert d["vs_baseline"] is None
    # nothing that names the card or the device holds a number
    for key, value in d.items():
        if key.startswith(("device_", "h2d_")) or "_card" in key:
            assert value is None, key
    assert "crashed" not in d and d["budget_skipped"] == []


def test_rehearsal_drove_every_group(rehearsal):
    d, _, _ = rehearsal
    cpu = d["rehearsal_cpu"]
    for key in ("cpu_path_corpus_Msamples_per_s",
                "cpu_path_dense_Msamples_per_s",
                "cpu_path_stream_whole_Msamples_per_s",
                "cpu_path_segments_per_s"):
        assert cpu[key]["median"] > 0 and len(cpu[key]["runs"]) == 2, key
        assert cpu[key]["min"] <= cpu[key]["median"] <= cpu[key]["max"]
    assert set(cpu["cpu_path_stream_window_Msamples_per_s"]) == {
        "40", "60", "full"}
    assert cpu["cpu_path_checksums_equal"] is True
    # host-side metrics are the host's own on any machine
    for key in ("host_corpus_Msamples_per_s",
                "host_corpus_all_threads_Msamples_per_s",
                "stream_whole_host_Msamples_per_s", "segments_host_per_s"):
        assert d[key]["median"] > 0, key
    assert d["scan_Msamples_per_s"] > 0
    assert d["corpus"]["files"] == 12 and d["repeats"] == 2
    assert d["cpu_count"] == os.cpu_count() and d["host_threads"] == 1
    # no kernel runs on the CPU: the counters stay at zero on every path
    assert all(n == 0 for path in cpu["cpu_path_launches"].values()
               for n in path.values())


# -- one definition of the data makers, pinned bytes -----------------------------


def test_corpus_bytes_are_pinned_and_shared_with_chip_smoke(bench):
    from libacm_tpu_torch import testing

    smoke = _load("chip_smoke_under_test", ROOT / "chip_smoke.py")
    files = bench.make_corpus(testing, 0.02)
    assert _corpus_digest(files) == CORPUS_SHA256_AT_0_02
    assert _corpus_digest(smoke.make_corpus(testing, 0.02)) \
        == CORPUS_SHA256_AT_0_02
    # one definition: chip_smoke.py holds the bench's objects, not copies
    for name in ("make_corpus", "long_stream", "bound"):
        assert getattr(smoke, name) is getattr(smoke.bench_torch, name)
        assert getattr(smoke, name).__code__.co_filename == str(_BENCH), name
    for name in ("MIX", "STREAM_BLOCKS", "STREAM_DISTINCT",
                 "STREAM_WINDOWS"):
        assert getattr(smoke, name) is getattr(smoke.bench_torch, name)
        assert getattr(smoke, name) == getattr(bench, name), name
    src = (ROOT / "chip_smoke.py").read_text()
    for name in ("make_corpus", "long_stream", "bound"):
        assert f"def {name}(" not in src, name


def test_long_stream_bytes_are_pinned(bench):
    from libacm_tpu_torch import testing
    from libacm_tpu_torch.parallel import build_index

    n_blocks, distinct, windows = bench.scaled_stream_shape(0.02)
    assert (n_blocks, distinct, windows) == (409, 16, (40, 60))
    assert bench.scaled_stream_shape(1.0) == (20480, 800, (2048, 3000))
    data = bench.long_stream(testing, build_index, bench.STREAM_SEED,
                             n_blocks, distinct)
    assert hashlib.sha256(data).hexdigest() == STREAM_SHA256_AT_0_02
    assert len(build_index(data).bitpos) == n_blocks
