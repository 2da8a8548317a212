"""CLI + output-stage tests: flag surface, sinks, native transport,
snapshot/resume.

The CLI mirrors the reference's option surface (plutogpssim.c:2296-2396);
end-to-end parity is asserted by generating an IQ file through the full
CLI path and comparing it against the compiled reference oracle.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from ref_harness import harness

from pluto_gps_sim_tpu.cli import main, parse_cli
from pluto_gps_sim_tpu.utils.native import NativeBuildError, RingWriter


def _snr_db(ref, got):
    ref = ref.astype(np.float64)
    d = ref - got.astype(np.float64)
    return 10 * np.log10(np.mean(ref**2) / max(np.mean(d**2), 1e-30))


# --------------------------------------------------------------------------
# flag surface


def test_parser_reference_flags():
    """Every reference getopt option parses (e:3:u:g:c:l:s:T:t:A:B:U:N:vfi)."""
    args = parse_cli([
        "-e", "nav.rnx", "-3", "-u", "um.csv", "-g", "x",
        "-c", "1,2,3", "-l", "4,5,6", "-s", "3000000",
        "-T", "now", "-t", "2023/01/10,00:00:00",
        "-A", "-30", "-B", "4.0", "-U", "uri:x", "-N", "pluto.local",
        "-v", "-f", "-i"])
    assert args.navfile == "nav.rnx" and args.rinex3 and args.umfile
    assert args.fs == 3_000_000.0 and args.gain_db == -30.0
    assert args.verbose and args.use_ftp and args.iono_off


def test_cli_errors():
    assert main(["-s", "3000000"]) == 1         # no -e/-f (c:2392-2395)
    assert main(["-e", "x", "-s", "999"]) == 1  # fs < 1 MHz (c:2326)


# --------------------------------------------------------------------------
# end-to-end CLI vs reference oracle


def test_cli_file_output_matches_oracle(oracle_exe, tmp_path, fixture_paths):
    cap = str(tmp_path / "ref.bin")
    harness.run_oracle(oracle_exe, fixture_paths["rinex2"], cap, 4,
                       extra_args=["-l", "35.681298,139.766247,10.0"])
    ref = harness.load_capture(cap)

    out = str(tmp_path / "ours.bin")
    rc = main(["-e", fixture_paths["rinex2"],
               "-l", "35.681298,139.766247,10.0",
               "-s", "3000000", "-d", str(ref.shape[0] / 10.0),
               "-o", out, "--mode", "precise"])
    assert rc == 0
    got = np.fromfile(out, dtype=np.int16).reshape(ref.shape[0], -1, 2)
    snr = _snr_db(ref.reshape(-1), got.reshape(-1))
    assert snr >= 60.0, f"CLI file vs oracle SNR {snr:.1f} dB"


def test_cli_snapshot_resume(tmp_path, fixture_paths):
    """Interrupt-and-resume must splice a bit-identical stream."""
    base = ["-e", fixture_paths["rinex2"], "-l", "35.681298,139.766247,10.0",
            "-s", "1000000", "--mode", "precise"]
    full = str(tmp_path / "full.bin")
    assert main(base + ["-d", "1.0", "-o", full]) == 0

    snap = str(tmp_path / "snap.npz")
    a = str(tmp_path / "a.bin")
    b = str(tmp_path / "b.bin")
    assert main(base + ["-d", "0.5", "-o", a, "--snapshot", snap]) == 0
    assert main(base + ["-d", "0.5", "-o", b, "--resume", snap]) == 0

    want = np.fromfile(full, dtype=np.int16)
    got = np.concatenate([np.fromfile(a, dtype=np.int16),
                          np.fromfile(b, dtype=np.int16)])
    assert want.size == got.size
    assert np.array_equal(want, got), "resumed stream is not seamless"


def test_cli_udp_sink(tmp_path, fixture_paths):
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 * 1024 * 1024)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.5)
    port = rx.getsockname()[1]

    got = bytearray()
    sender_done = threading.Event()

    def drain():
        # keep polling until the sender has finished AND the socket drains
        while len(got) < 4 * 100_000:
            try:
                data, _ = rx.recvfrom(65536)
                got.extend(data)
            except socket.timeout:
                if sender_done.is_set():
                    break

    t = threading.Thread(target=drain)
    t.start()
    rc = main(["-e", fixture_paths["rinex2"],
               "-l", "35.681298,139.766247,10.0",
               "-s", "1000000", "-d", "0.1", "--sink", "udp",
               "--udp-host", "127.0.0.1", "--udp-port", str(port),
               "--mode", "precise"])
    sender_done.set()
    t.join()
    rx.close()
    assert rc == 0
    # loopback UDP can drop under load; require at least half the bytes
    # (empirically all 400000 arrive — 277 full datagrams + 1 partial)
    assert len(got) >= 2 * 100_000, f"received only {len(got)} bytes"


# --------------------------------------------------------------------------
# native ring writer (C++ transport)


def test_ring_writer_integrity(tmp_path):
    """All bytes arrive, in order, across wrap-arounds."""
    path = str(tmp_path / "ring.bin")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    rng = np.random.RandomState(0)
    chunks = [rng.randint(-2**15, 2**15, rng.randint(100, 50_000),
                          dtype=np.int16) for _ in range(40)]
    try:
        rw = RingWriter(fd, capacity=64 * 1024)   # force many wraps
    except NativeBuildError as e:
        pytest.skip(f"no native toolchain: {e}")
    with rw:
        for c in chunks:
            rw.push(c)
    os.close(fd)
    want = np.concatenate(chunks)
    got = np.fromfile(path, dtype=np.int16)
    assert np.array_equal(want, got)
    assert rw.stats()["bytes_written"] == want.nbytes


def test_ring_writer_pacing(tmp_path):
    """Paced mode drains at ~bytes_per_sec, independent of push speed."""
    path = str(tmp_path / "paced.bin")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    n = 400_000  # bytes
    rate = 1_000_000.0  # 1 MB/s -> ~0.4 s
    try:
        rw = RingWriter(fd, capacity=2 * n, bytes_per_sec=rate,
                        chunk_bytes=40_000)
    except NativeBuildError as e:
        pytest.skip(f"no native toolchain: {e}")
    data = np.zeros(n, dtype=np.int8)
    t0 = time.time()
    rw.push(data)
    rw.close()
    dt = time.time() - t0
    os.close(fd)
    assert os.path.getsize(path) == n
    # first chunk emits immediately -> expect ~(n - chunk)/rate
    assert 0.25 <= dt <= 1.5, f"paced drain took {dt:.3f}s, expected ~0.36s"


def test_ring_writer_partial_chunk_pacing(tmp_path):
    """Sustained partial-chunk pops must pace to bytes_per_sec, not to
    whole-chunk periods (the round-1 deadline advanced by
    ceil(n/chunk) periods, slowing the stream whenever the producer
    trickled less than a chunk at a time)."""
    path = str(tmp_path / "partial.bin")
    fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
    rate = 1_000_000.0
    chunk = 50_000
    try:
        rw = RingWriter(fd, capacity=4 * chunk, bytes_per_sec=rate,
                        chunk_bytes=chunk)
    except NativeBuildError as e:
        pytest.skip(f"no native toolchain: {e}")
    piece = np.zeros(chunk // 4, dtype=np.int8)   # quarter-chunk pieces
    t0 = time.time()
    for _ in range(24):                           # 300k bytes total
        rw.push(piece)
        time.sleep(0.005)   # trickle: consumer usually sees partials
    rw.close()
    dt = time.time() - t0
    os.close(fd)
    assert os.path.getsize(path) == 24 * piece.nbytes
    # 300 kB at 1 MB/s ~= 0.3 s; the old whole-chunk rounding paced a
    # quarter-chunk pop as a FULL chunk period (4x slow -> ~1.2 s)
    assert dt <= 0.8, f"partial-chunk drain took {dt:.3f}s (paced slow)"
    assert dt >= 0.15, f"drained in {dt:.3f}s - pacing not applied"


def test_udp_realtime_pacing(tmp_path):
    """Native datagram pacing: fixed-size packets at ~4*fs bytes/s."""
    from pluto_gps_sim_tpu.runtime.sinks import UdpRealtimeSink

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 * 1024 * 1024)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.5)
    port = rx.getsockname()[1]

    fs = 1_000_000.0  # 4 MB/s -> 0.4 s for 0.4 s of signal
    n = 400_000       # samples
    data = np.zeros((n, 2), dtype=np.int16)

    sizes = []
    done = threading.Event()

    def drain():
        got = 0
        while got < 4 * n:
            try:
                pkt, _ = rx.recvfrom(65536)
            except socket.timeout:
                if done.is_set():
                    break
                continue
            sizes.append(len(pkt))
            got += len(pkt)

    t = threading.Thread(target=drain)
    t.start()
    try:
        sink = UdpRealtimeSink("127.0.0.1", port, fs)
    except Exception as e:
        done.set()
        t.join()
        rx.close()
        pytest.skip(f"no native toolchain: {e}")
    t0 = time.time()
    sink.write(data)
    sink.close()   # drains the ring at the paced rate
    dt = time.time() - t0
    done.set()
    t.join()
    rx.close()

    received = sum(sizes)
    assert received >= 4 * n // 2, f"received only {received} bytes"
    # all mid-stream datagrams are exactly payload-sized (360 samples)
    assert set(sizes[:-1]) == {1440}, set(sizes)
    # paced: 1.6 MB at 4 MB/s should take ~0.4 s (first chunk immediate)
    assert dt >= 0.25, f"drained in {dt:.3f}s - pacing not applied"


def test_udp_realtime_tolerates_absent_receiver():
    """Fire-and-forget: ECONNREFUSED (nobody listening) must not abort
    the paced stream."""
    from pluto_gps_sim_tpu.runtime.sinks import UdpRealtimeSink
    try:
        sink = UdpRealtimeSink("127.0.0.1", 9, 1_000_000.0)  # discard port
    except Exception as e:
        pytest.skip(f"no native toolchain: {e}")
    data = np.zeros((100_000, 2), dtype=np.int16)
    sink.write(data)      # would raise IOError if the consumer aborted
    sink.write(data)
    sink.close()
    # all datagrams were "written" (dropped fire-and-forget), and
    # post-close stats return the drained totals
    assert sink.stats()["bytes_written"] == 2 * 400_000


def test_cli_shard_concatenates_identically(tmp_path, fixture_paths):
    """--shard H/N: the N per-host output files concatenate to the
    unsharded stream byte for byte (multi-host delivery at CLI level)."""
    base = ["-e", fixture_paths["rinex2"], "-l", "35.681298,139.766247,10.0",
            "-s", "1000000", "--mode", "tiled", "-d", "1.5"]
    full = str(tmp_path / "full.bin")
    assert main(base + ["-o", full]) == 0
    parts = []
    for h in range(2):
        p = str(tmp_path / f"part{h}.bin")
        assert main(base + ["-o", p, "--shard", f"{h}/2",
                            "--dispatch-superframes", "2"]) == 0
        parts.append(np.fromfile(p, dtype=np.int16))
    want = np.fromfile(full, dtype=np.int16)
    got = np.concatenate(parts)
    assert want.size == got.size and np.array_equal(want, got)

    # --shard validation (H out of range / malformed)
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        main(base + ["--shard", "2/2", "-o", full])
    with _pytest.raises(SystemExit):
        main(base + ["--shard", "x", "-o", full])


def test_cli_stats_reports_patch_dropped(tmp_path, fixture_paths, capsys):
    """--stats in fused mode surfaces the gain-trunc patch overflow
    counter (normally 0; nonzero means some LUT entries degraded to the
    device's f32 trunc — a +-1 LSB effect users should see)."""
    out = str(tmp_path / "s.bin")
    rc = main(["-e", fixture_paths["rinex2"],
               "-l", "35.681298,139.766247,10.0",
               "-s", "1000000", "-d", "0.5", "-o", out,
               "--mode", "fused", "--stats"])
    assert rc == 0
    err = capsys.readouterr().err
    line = next(ln for ln in err.splitlines() if ln.startswith("sink stats"))
    stats = json.loads(line.split("sink stats: ", 1)[1])
    assert "patch_dropped" in stats and stats["patch_dropped"] >= 0
    assert stats["samples"] == 500_000


def test_cli_selfcheck(tmp_path, fixture_paths, capsys):
    """--selfcheck re-acquires every planned PRN from the written file
    and FAILs (rc=1) when the IQ does not carry them."""
    out = str(tmp_path / "sc.bin")
    rc = main(["-e", fixture_paths["rinex2"],
               "-l", "35.681298,139.766247,10.0",
               "-s", "2600000", "-d", "0.2", "-o", out,
               "--mode", "tiled", "--selfcheck"])
    err = capsys.readouterr().err
    assert rc == 0
    assert "selfcheck: PASS" in err
    assert err.count("HIT") >= 4

    # noise in place of signal -> acquisitions miss -> FAIL verdict
    from pluto_gps_sim_tpu.cli import _selfcheck
    n = np.fromfile(out, dtype=np.int16).size
    rng = np.random.RandomState(7)
    rng.randint(-500, 500, n).astype(np.int16).tofile(out)
    assert _selfcheck(out, 2_600_000.0, [3, 5, 6]) is False
    assert "selfcheck: FAIL" in capsys.readouterr().err
