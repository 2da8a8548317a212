"""Output sinks for the int16 IQ stream.

The reference has exactly one sink — the ADALM-Pluto SDR over libiio
(pluto_tx_thread_ep, plutogpssim.c:2058-2190).  This framework makes the
output stage pluggable:

  file    gps-sdr-sim-compatible interleaved int16 IQ .bin file
  stdout  same bytes to a pipe (feed gqrx, GNU Radio, nc, ...)
  udp     datagrams to host:port (for an off-box SDR bridge)
  null    discard (benchmarks)
  iio     thin host-side ADALM-Pluto bridge, only if a libiio Python
          binding is importable (optional hardware extra; the
          framework core never requires SDR hardware)

Any sink can be wrapped in real-time pacing backed by the native C++
ring writer (utils/native.py) — the equivalent of the reference's
blocking iio_buffer_push clocking the program to fs (c:2152) — except
the device producer runs ahead and the ring absorbs the slack.
"""

from __future__ import annotations

import os
import socket
import sys

import numpy as np

__all__ = ["open_sink", "FileSink", "FdSink", "UdpSink", "NullSink",
           "IioSink", "RealtimeSink", "UdpRealtimeSink", "StatsSink"]


def _as_bytes(block: np.ndarray) -> np.ndarray:
    """[..., 2] int16 IQ -> contiguous int16 view ready to write."""
    arr = np.ascontiguousarray(block)
    if arr.dtype != np.int16:
        raise TypeError(f"IQ blocks must be int16, got {arr.dtype}")
    return arr


class FdSink:
    """Writes interleaved int16 IQ to a file descriptor."""

    def __init__(self, fd: int, close_fd: bool = False):
        self.fd = fd
        self._close_fd = close_fd
        self.bytes_written = 0

    def write(self, block: np.ndarray) -> None:
        data = _as_bytes(block).tobytes()
        view = memoryview(data)
        while view:  # os.write may partial-write on pipes/sockets
            n = os.write(self.fd, view)
            view = view[n:]
        self.bytes_written += len(data)

    def close(self) -> None:
        if self._close_fd and self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FileSink(FdSink):
    """gps-sdr-sim-compatible IQ file (interleaved little-endian int16)."""

    def __init__(self, path: str):
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        super().__init__(fd, close_fd=True)
        self.path = path


class NullSink:
    def __init__(self):
        self.bytes_written = 0

    def write(self, block: np.ndarray) -> None:
        self.bytes_written += _as_bytes(block).nbytes

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class UdpSink:
    """Chunks IQ into UDP datagrams (payload_samples complex per packet)."""

    def __init__(self, host: str, port: int, payload_samples: int = 360):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.payload_bytes = payload_samples * 4
        self.bytes_written = 0

    def write(self, block: np.ndarray) -> None:
        data = _as_bytes(block).tobytes()
        for off in range(0, len(data), self.payload_bytes):
            self.sock.sendto(data[off:off + self.payload_bytes], self.addr)
        self.bytes_written += len(data)

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class IioSink:
    """Optional ADALM-Pluto bridge through a libiio Python binding.

    Mirrors the reference's PHY setup and LO power sequencing
    (plutogpssim.c:2095-2141): 12 kernel buffers, port A, RF bandwidth,
    fs, hardware gain on the voltage0 PHY channel, RX LO (altvoltage0)
    powered down, TX LO (altvoltage1) tuned to L1 1575.42 MHz, I/Q TX
    channels enabled; the TX LO is powered UP only after the first
    stream buffer exists (c:2139-2141) and powered back DOWN at teardown
    (c:2162-2165) so the SDR never radiates an unmodulated carrier.
    Import is deferred and failure is a clean error — SDR hardware is an
    optional extra, never a framework dependency.
    """

    def __init__(self, fs: float, bw_hz: float, gain_db: float,
                 uri: str | None = None, hostname: str | None = None,
                 lo_hz: float = 1_575_420_000.0):
        try:
            import iio  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "IIO sink requires the libiio Python binding (pylibiio); "
                "use --sink file/stdout/udp instead, or pipe to an SDR "
                "host tool") from e
        if uri:
            self.ctx = iio.Context(uri)
        elif hostname:
            self.ctx = iio.NetworkContext(hostname)
        else:
            self.ctx = iio.Context()
        phy = self.ctx.find_device("ad9361-phy")
        tx = self.ctx.find_device("cf-ad9361-dds-core-lpc")
        if phy is None or tx is None:
            raise RuntimeError("PlutoSDR devices not found in IIO context")
        # additional IQ kernel buffers, default is 4 (c:2103)
        if hasattr(tx, "set_kernel_buffers_count"):
            tx.set_kernel_buffers_count(12)
        ch = phy.find_channel("voltage0", True)
        ch.attrs["rf_port_select"].value = "A"
        ch.attrs["rf_bandwidth"].value = str(int(bw_hz))
        ch.attrs["sampling_frequency"].value = str(int(fs))
        ch.attrs["hardwaregain"].value = str(float(gain_db))
        # RX LO off, TX LO tuned but still powered down (c:2112-2118)
        phy.find_channel("altvoltage0", True).attrs["powerdown"].value = "1"
        self._tx_lo = phy.find_channel("altvoltage1", True)
        self._tx_lo.attrs["frequency"].value = str(int(lo_hz))
        self._i = tx.find_channel("voltage0", True)
        self._q = tx.find_channel("voltage1", True)
        if self._i is None or self._q is None:
            raise RuntimeError(
                "PlutoSDR TX I/Q channels (voltage0/voltage1) not found")
        self._i.enabled = True
        self._q.enabled = True
        self._iio = iio
        self._tx = tx
        self._buf = None
        self.bytes_written = 0

    def write(self, block: np.ndarray) -> None:
        data = _as_bytes(block)
        n = data.size // 2
        if self._buf is None or self._buf_len != n:
            first = self._buf is None
            self._buf = self._iio.Buffer(self._tx, n, False)
            self._buf_len = n
            if first:  # TX LO up once the stream buffer exists (c:2139)
                self._tx_lo.attrs["powerdown"].value = "0"
        self._buf.write(bytearray(data.tobytes()))
        self._buf.push()
        self.bytes_written += data.nbytes

    def close(self) -> None:
        if self.ctx is not None:
            try:  # TX LO down before teardown (c:2162-2165)
                self._tx_lo.attrs["powerdown"].value = "1"
                self._i.enabled = False
                self._q.enabled = False
            except Exception:
                pass  # context already gone; nothing left to power down
        self._buf = None
        self.ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RealtimeSink:
    """Wraps an fd-backed sink with the native paced ring writer.

    The consumer thread emits bytes at exactly 4*fs bytes/s (int16 I+Q),
    the producer blocks only when the ring is full — the framework's
    equivalent of the reference's real-time contract, with the ring
    absorbing the device's >>1x generation speed.
    """

    def __init__(self, fd: int, fs: float, close_fd: bool = False,
                 ring_seconds: float = 2.0, block_samples: int | None = None,
                 payload_samples: int | None = None):
        from ..utils.native import RingWriter
        datagram = payload_samples is not None
        chunk = (payload_samples if datagram
                 else (block_samples or int(round(fs / 10)))) * 4
        cap = max(int(ring_seconds * fs * 4), 8 * chunk)
        self._rw = RingWriter(fd, cap, bytes_per_sec=4.0 * fs,
                              chunk_bytes=chunk, datagram=datagram)
        self._fd = fd
        self._close_fd = close_fd
        self.bytes_written = 0

    def write(self, block: np.ndarray) -> None:
        data = _as_bytes(block)
        self._rw.push(data)
        self.bytes_written += data.nbytes

    def stats(self) -> dict:
        return self._rw.stats()  # RingWriter caches final stats post-close

    def close(self) -> None:
        self._rw.close()  # idempotent; drains at the paced rate
        if self._close_fd and self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class UdpRealtimeSink(RealtimeSink):
    """UDP datagrams paced to fs by the native ring writer.

    A connected SOCK_DGRAM socket turns each consumer-thread write()
    into one datagram; the ring writer emits fixed payload_samples-sized
    packets on absolute deadlines, so a receiver sees the stream at
    exactly 4*fs bytes/s regardless of how far ahead the device runs.
    Transient delivery errors (absent receiver, routing blips) drop
    packets fire-and-forget without stopping the stream."""

    def __init__(self, host: str, port: int, fs: float,
                 payload_samples: int = 360, ring_seconds: float = 2.0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            self.sock.connect((host, port))
            super().__init__(self.sock.fileno(), fs,
                             ring_seconds=ring_seconds,
                             payload_samples=payload_samples)
        except Exception:
            self.sock.close()
            raise

    def close(self) -> None:
        super().close()
        self.sock.close()


class StatsSink:
    """Observability wrapper: counts samples, tracks throughput and a
    running CRC32 of the stream (per-block checksums chained), so two
    runs can be compared without storing the IQ.  The reference has no
    metrics at all (stderr printfs only, SURVEY.md section 5)."""

    def __init__(self, inner):
        import time
        import zlib
        self._inner = inner
        self._crc32 = zlib.crc32
        self._t0 = time.time()
        self._time = time.time
        self.writes = 0
        self.samples = 0
        self.crc = 0

    def write(self, block: np.ndarray) -> None:
        data = _as_bytes(block)
        self._inner.write(data)
        self.writes += 1
        self.samples += data.size // 2
        self.crc = self._crc32(data.tobytes(), self.crc)

    def stats(self) -> dict:
        el = max(self._time() - self._t0, 1e-9)
        out = {"writes": self.writes, "samples": self.samples,
               "crc32": f"{self.crc:08x}",
               "samples_per_sec": round(self.samples / el, 1)}
        if hasattr(self._inner, "stats"):
            out["transport"] = self._inner.stats()
        return out

    def close(self) -> None:
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_sink(kind: str, *, path: str | None = None, fs: float = 2.6e6,
              realtime: bool = False, udp_host: str = "127.0.0.1",
              udp_port: int = 5015, bw_hz: float = 3e6,
              gain_db: float = -20.0, uri: str | None = None,
              hostname: str | None = None,
              block_samples: int | None = None):
    """Factory: sink spec -> sink object."""
    if kind in ("null", "udp", "iio"):
        if kind == "udp" and realtime:
            try:
                return UdpRealtimeSink(udp_host, udp_port, fs)
            except Exception as e:
                print(f"WARNING: native paced UDP unavailable ({e}); "
                      f"sending unpaced", file=sys.stderr)
        elif realtime:
            # the iio sink is hardware-paced; null has nothing to pace
            print(f"WARNING: --realtime has no effect on the {kind} sink",
                  file=sys.stderr)
        if kind == "null":
            return NullSink()
        if kind == "udp":
            return UdpSink(udp_host, udp_port)
        return IioSink(fs, bw_hz, gain_db, uri=uri, hostname=hostname)
    if kind == "stdout":
        fd, close_fd = sys.stdout.fileno(), False
    elif kind == "file":
        if not path:
            raise ValueError("file sink needs a path")
        sink = FileSink(path)
        if not realtime:
            return sink
        fd, close_fd = sink.fd, True
        sink._close_fd = False  # RealtimeSink owns the fd now
    else:
        raise ValueError(f"unknown sink {kind!r}")
    if realtime:
        try:
            return RealtimeSink(fd, fs, close_fd=close_fd,
                                block_samples=block_samples)
        except Exception as e:
            print(f"WARNING: native ring writer unavailable ({e}); "
                  f"falling back to unpaced writes", file=sys.stderr)
    return FdSink(fd, close_fd=close_fd)
