"""ctypes bindings for the native C++ runtime (wire-protocol codec + robot
simulator).  Builds lazily with make on first use; see protocol.cc for the
reference-behavior citations."""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libgridmap_native.so")
_lib = None


def _build() -> None:
    """Compile protocol.cc with make into a private file, then rename it
    into place: concurrent first users (test workers) never load a
    half-written library."""
    tmp = f"{_LIB_PATH}.tmp{os.getpid()}"
    subprocess.run(["make", "-C", _DIR, "-B", f"TARGET={tmp}"], check=True,
                   capture_output=True)
    os.replace(tmp, _LIB_PATH)


def load():
    """Load (building if needed or stale) the native library."""
    global _lib
    if _lib is not None:
        return _lib
    src_path = os.path.join(_DIR, "protocol.cc")
    if (not os.path.exists(_LIB_PATH)
            or os.path.getmtime(src_path) > os.path.getmtime(_LIB_PATH)):
        _build()
    lib = ctypes.CDLL(_LIB_PATH)
    lib.gs_parser_new.restype = ctypes.c_void_p
    lib.gs_parser_free.argtypes = [ctypes.c_void_p]
    lib.gs_parser_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.gs_parser_pending.argtypes = [ctypes.c_void_p]
    lib.gs_parser_pending.restype = ctypes.c_int
    lib.gs_parser_pop.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int16), np.ctypeslib.ndpointer(np.int16),
        np.ctypeslib.ndpointer(np.int16),
        ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16)]
    lib.gs_parser_pop.restype = ctypes.c_int
    lib.gs_tfmini_encode.argtypes = [ctypes.c_uint16, ctypes.c_uint16,
                                     ctypes.c_uint8,
                                     np.ctypeslib.ndpointer(np.uint8)]
    lib.gs_tfmini_encode.restype = ctypes.c_int
    lib.gs_tfmini_new.restype = ctypes.c_void_p
    lib.gs_tfmini_free.argtypes = [ctypes.c_void_p]
    lib.gs_tfmini_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.gs_tfmini_pending.argtypes = [ctypes.c_void_p]
    lib.gs_tfmini_pending.restype = ctypes.c_int
    lib.gs_tfmini_pop.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint16),
                                  ctypes.POINTER(ctypes.c_uint16),
                                  ctypes.POINTER(ctypes.c_uint8)]
    lib.gs_tfmini_pop.restype = ctypes.c_int
    lib.gs_sim_home.argtypes = [ctypes.c_void_p]
    lib.gs_sim_turret_step.argtypes = [ctypes.c_void_p]
    lib.gs_sim_turret_step.restype = ctypes.c_int
    lib.gs_encode_measurement.argtypes = [ctypes.c_int16, ctypes.c_int16,
                                          ctypes.c_int16,
                                          np.ctypeslib.ndpointer(np.uint8)]
    lib.gs_encode_wheel_speeds.argtypes = [ctypes.c_float, ctypes.c_float,
                                           np.ctypeslib.ndpointer(np.uint8)]
    lib.gs_encode_wheel_speeds.restype = ctypes.c_int
    lib.gs_sim_new.restype = ctypes.c_void_p
    lib.gs_sim_new.argtypes = [np.ctypeslib.ndpointer(np.float64),
                               ctypes.c_int, ctypes.c_double, ctypes.c_double,
                               ctypes.c_double, ctypes.c_uint32]
    lib.gs_sim_free.argtypes = [ctypes.c_void_p]
    lib.gs_sim_set_speeds.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                      ctypes.c_double]
    lib.gs_sim_set_resolution.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.gs_sim_pose.argtypes = [ctypes.c_void_p,
                                np.ctypeslib.ndpointer(np.float64)]
    lib.gs_sim_revolution.argtypes = [ctypes.c_void_p,
                                      np.ctypeslib.ndpointer(np.uint8),
                                      ctypes.c_int, ctypes.c_double]
    lib.gs_sim_revolution.restype = ctypes.c_int
    lib.gs_recording_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
    lib.gs_recording_scan.restype = ctypes.c_int
    lib.gs_recording_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.float64),
        np.ctypeslib.ndpointer(np.uint8)]
    _lib = lib
    return lib


def parse_recording(data: bytes):
    """Native reader for the reference recording format: one C pass over
    the whole file into flat arrays (the data-loader counterpart of the
    wire-protocol codec; byte-exact vs io/recording.read_recording's
    Python parser, tests/test_native.py).

    Returns (t (N,) f32, d_center (N,) f64, d_theta (N,) f64,
    m_counts (N,) i32, angle (Mtot,) f64, dist (Mtot,) f64,
    hit (Mtot,) u1).  Raises ValueError on a bad header or truncation
    (same message family as the Python reader)."""
    lib = load()
    nf = ctypes.c_int(0)
    mt = ctypes.c_long(0)
    rc = lib.gs_recording_scan(data, len(data), ctypes.byref(nf),
                               ctypes.byref(mt))
    if rc == -1:
        raise ValueError(f"bad header byte {data[0] if data else -1:#x}, "
                         f"want 0xff")
    if rc != 0:
        raise ValueError("truncated recording")
    n, m = nf.value, mt.value
    t = np.empty(n, np.float32)
    d_center = np.empty(n, np.float64)
    d_theta = np.empty(n, np.float64)
    m_counts = np.empty(n, np.int32)
    angle = np.empty(m, np.float64)
    dist = np.empty(m, np.float64)
    hit = np.empty(m, np.uint8)
    lib.gs_recording_parse(data, len(data), t, d_center, d_theta, m_counts,
                           angle, dist, hit)
    return t, d_center, d_theta, m_counts, angle, dist, hit


class WireParser:
    """Streaming parser of robot wire packets -> complete revolutions
    (native equivalent of conn/ConnectionThread.java:41-102)."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.gs_parser_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gs_parser_free(self._h)
            self._h = None

    def feed(self, data: bytes) -> None:
        self._lib.gs_parser_feed(self._h, data, len(data))

    def pending(self) -> int:
        return self._lib.gs_parser_pending(self._h)

    def pop(self) -> Optional[Tuple[np.ndarray, np.ndarray, int, int]]:
        """Returns (steps, front_mm, left_count, right_count) or None."""
        r = self.pop_full()
        if r is None:
            return None
        steps, front, _back, lc, rc = r
        return steps, front, lc, rc

    def pop_full(self) -> Optional[
            Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]]:
        """Returns (steps, front_mm, back, left_count, right_count) or None.
        `back` is the packet's 4th field: TFMini signal strength on the
        current firmware (esp32/sensor.cpp:219-222), the rear VL53L1X
        distance on the ARDUINO generation (SURVEY.md 2.7)."""
        steps = np.zeros(720, np.int16)
        front = np.zeros(720, np.int16)
        back = np.zeros(720, np.int16)
        lc = ctypes.c_int16()
        rc = ctypes.c_int16()
        n = self._lib.gs_parser_pop(self._h, steps, front, back,
                                    ctypes.byref(lc), ctypes.byref(rc))
        if n < 0:
            return None
        return (steps[:n].copy(), front[:n].copy(), back[:n].copy(),
                lc.value, rc.value)


class TFMiniCodec:
    """TFMini 9-byte UART frame codec (TFmini.h:230-315): streaming decoder
    with header resync + checksum validation, and the matching encoder so a
    simulated sensor can produce real TFMini byte streams."""

    def __init__(self):
        self._lib = load()
        self._h = self._lib.gs_tfmini_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gs_tfmini_free(self._h)
            self._h = None

    def feed(self, data: bytes) -> None:
        self._lib.gs_tfmini_feed(self._h, data, len(data))

    def pending(self) -> int:
        return self._lib.gs_tfmini_pending(self._h)

    def pop(self) -> Optional[Tuple[int, int, int]]:
        """Returns (distance, strength, integration_time) or None."""
        d = ctypes.c_uint16()
        s = ctypes.c_uint16()
        t = ctypes.c_uint8()
        if not self._lib.gs_tfmini_pop(self._h, ctypes.byref(d),
                                       ctypes.byref(s), ctypes.byref(t)):
            return None
        return d.value, s.value, t.value

    @staticmethod
    def encode(distance: int, strength: int, int_time: int = 0) -> bytes:
        lib = load()
        out = np.zeros(9, np.uint8)
        lib.gs_tfmini_encode(distance, strength, int_time, out)
        return bytes(out)


class RobotSim:
    """Native simulated robot streaming firmware-format bytes (PID wheel
    control + stepper turret scans; see protocol.cc)."""

    def __init__(self, segments: np.ndarray, start=(0.0, 0.0, 0.0),
                 seed: int = 1):
        self._lib = load()
        segs = np.ascontiguousarray(segments, np.float64).reshape(-1, 4)
        self._h = self._lib.gs_sim_new(segs.reshape(-1), len(segs),
                                       start[0], start[1], start[2], seed)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gs_sim_free(self._h)
            self._h = None

    def set_speeds(self, left: float, right: float) -> None:
        self._lib.gs_sim_set_speeds(self._h, left, right)

    def set_resolution(self, degrees: int) -> None:
        self._lib.gs_sim_set_resolution(self._h, degrees)

    def home(self) -> None:
        """Home the sensor turret (cmd 0x05, esp32/sensor.cpp:247-276)."""
        self._lib.gs_sim_home(self._h)

    @property
    def turret_step(self) -> int:
        return self._lib.gs_sim_turret_step(self._h)

    @property
    def pose(self) -> np.ndarray:
        out = np.zeros(3, np.float64)
        self._lib.gs_sim_pose(self._h, out)
        return out

    def revolution(self, range_noise_sd: float = 0.01) -> bytes:
        buf = np.zeros(8 * 721, np.uint8)
        n = self._lib.gs_sim_revolution(self._h, buf, len(buf),
                                        range_noise_sd)
        return bytes(buf[:n])


def wire_to_frames(parser: WireParser, robot_cfg, max_range: float = 10.0
                   ) -> List:
    """Drain complete revolutions into host RecordedFrames using the
    reference's conversion (conn/ConnectionThread.java:71-92)."""
    from ..io.recording import RecordedFrame

    frames = []
    while True:
        rev = parser.pop()
        if rev is None:
            break
        steps, front_mm, lc, rc = rev
        angle = (steps.astype(np.float64)
                 / robot_cfg.sensor_steps_per_rev * 2 * np.pi
                 + robot_cfg.sensor_angle_offset)
        dist = front_mm.astype(np.float64) / 1000.0
        hit = front_mm >= 0
        dist = np.where(hit, dist, max_range)
        d_left = lc / robot_cfg.motor_steps_per_rev * np.pi * \
            robot_cfg.wheel_diameter
        d_right = rc / robot_cfg.motor_steps_per_rev * np.pi * \
            robot_cfg.wheel_diameter
        frames.append(RecordedFrame(
            t=0.0, d_center=(d_left + d_right) / 2,
            d_theta=(d_right - d_left) / robot_cfg.wheel_distance,
            angle=angle, dist=dist, hit=hit))
    return frames
