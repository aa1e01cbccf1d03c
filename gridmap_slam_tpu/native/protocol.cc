// Wire-protocol codec + differential-drive robot simulator (C++ runtime).
//
// The reference's native layer is its firmware: the ESP32 streams packed
// measurement frames over TCP (robot/esp32/sensor.cpp:11-15, :182-209) and
// the Java side parses them on a reader thread (conn/ConnectionThread.java:
// 41-102).  This library reimplements that native behavior for the
// engine's host side:
//
//   * encode/decode of the measurement wire format
//       {u16 magic 0x55AA, i16 steps, i16 front, i16 back}  (little-endian)
//     with steps<0 marking end-of-revolution + encoder odometry,
//   * a streaming parser that consumes raw bytes (arbitrary chunking, with
//     resync on the magic) and emits complete revolutions,
//   * command encoding (host->robot bytes 0x01..0x18,
//     conn/ConnectionManager.java:40-44, esp32/sensor.cpp:60-111),
//   * a simulated robot: 100 Hz PID wheel-speed loop with filtered
//     derivative (robot/esp32/pid.cpp:4-28, motors.cpp:124-189), quadrature
//     encoder counts, stepper-turret scan generation against a segment
//     world — producing byte streams indistinguishable from the firmware's.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint16_t kMagic = 0x55AA;            // esp32/sensor.cpp:11
constexpr int kMaxSteps = 720;                  // pins.h:17

#pragma pack(push, 1)
struct Packet {                                 // esp32/sensor.cpp:11-15
  uint16_t magic;
  int16_t steps;
  int16_t front;
  int16_t back;
};
#pragma pack(pop)
static_assert(sizeof(Packet) == 8, "packet must be 8 bytes");

struct Measurement {
  int16_t steps;
  int16_t front_mm;
  int16_t back;     // TFMini signal strength (ARDUINO generation: 2nd sensor)
};

struct Revolution {
  std::vector<Measurement> meas;
  int16_t left_count = 0;
  int16_t right_count = 0;
  bool complete = false;
};

// --- streaming parser ----------------------------------------------------
struct Parser {
  std::vector<uint8_t> buf;
  Revolution current;
  std::vector<Revolution> done;

  void feed(const uint8_t* data, size_t n) {
    buf.insert(buf.end(), data, data + n);
    size_t off = 0;
    while (buf.size() - off >= sizeof(Packet)) {
      // resync on little-endian magic 0xAA 0x55
      if (!(buf[off] == 0xAA && buf[off + 1] == 0x55)) {
        ++off;
        continue;
      }
      Packet p;
      std::memcpy(&p, buf.data() + off, sizeof(Packet));
      off += sizeof(Packet);
      if (p.steps < 0) {
        // end-of-revolution marker carrying odometry counts
        // (esp32/sensor.cpp:188-194; conn/ConnectionThread.java:63-69)
        current.left_count = p.front;
        current.right_count = p.back;
        current.complete = true;
        done.push_back(std::move(current));
        current = Revolution{};
      } else if (p.steps < kMaxSteps) {
        current.meas.push_back({p.steps, p.front, p.back});
      }
    }
    buf.erase(buf.begin(), buf.begin() + off);
  }
};

// --- TFMini 9-byte UART frame codec (TFmini.h:230-315) ---------------------
// Standard-format frame: 0x59 0x59, dist LE u16, strength LE u16,
// integration time, reserved, checksum = low byte of the sum of bytes 0..7.
constexpr uint8_t kTfHeader = 0x59;

struct TfReading {
  uint16_t dist;
  uint16_t strength;
  uint8_t int_time;
};

struct TfDecoder {
  uint8_t frame[9];
  int have = 0;
  std::vector<TfReading> done;

  void feed(const uint8_t* data, size_t n) {
    for (size_t i = 0; i < n; ++i) {
      uint8_t b = data[i];
      if (have == 0) {
        if (b == kTfHeader) frame[have++] = b;
      } else if (have == 1) {
        if (b == kTfHeader) frame[have++] = b;
        else have = 0;
      } else {
        frame[have++] = b;
        if (have == 9) {
          uint32_t sum = 0;
          for (int k = 0; k < 8; ++k) sum += frame[k];
          if (static_cast<uint8_t>(sum) == frame[8]) {
            done.push_back({
                static_cast<uint16_t>(frame[2] | (frame[3] << 8)),
                static_cast<uint16_t>(frame[4] | (frame[5] << 8)),
                frame[6]});
          }
          have = 0;  // bad checksum: drop frame, resync on next header
        }
      }
    }
  }
};

// --- PID (pid.cpp:4-28) --------------------------------------------------
struct Pid {
  double kp = 0.5528, ki = 1.6446, kd = 0.0102, tf = 1.0 / 11.821;  // motors.h:14-17
  double i = 0, d = 0, e_old = 0;

  double step(double e, double h) {
    d = tf / (tf + h) * d + kd / (tf + h) * (e - e_old);
    double u = kp * e + i + d;
    i += ki * h * e;                 // integral post-update (pid.cpp:15)
    e_old = e;
    return u;
  }
  void reset() { i = d = e_old = 0; }
};

// --- simulated robot -----------------------------------------------------
struct Motor {
  Pid pid;
  double speed = 0;                 // rad/s actual
  double reference = 0;             // rad/s commanded
  double odom_accum = 0;            // accumulated encoder counts (fractional)
  int32_t odom_counter = 0;         // counts since last revolution marker
};

struct Sim {
  // world geometry
  std::vector<double> segs;         // x0,y0,x1,y1 quads
  double x = 0, y = 0, theta = 0;
  Motor left, right;
  double wheel_distance = 0.22;     // Robot.java:8
  double wheel_radius = 0.063 / 2;  // Robot.java:11
  double counts_per_rev = 960;      // Robot.java:14
  double max_range_m = 10.0;
  int steps_per_rev = 720;          // pins.h:17
  int degrees_per_step = 2;         // ConnectionManager default resolution
  int turret_step = 0;              // persistent turret position (un-homed
                                    // turrets start at an arbitrary step)
  uint32_t rng = 12345;

  double frand() {                  // xorshift uniform [0,1)
    rng ^= rng << 13; rng ^= rng >> 17; rng ^= rng << 5;
    return (rng >> 8) * (1.0 / 16777216.0);
  }
  double nrand() {                  // Box-Muller
    double u1 = frand() + 1e-12, u2 = frand();
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
  }

  // one 100 Hz motor-control tick (motors.cpp:101-141)
  void motor_tick(double h) {
    for (Motor* m : {&left, &right}) {
      double u = m->pid.step(m->reference - m->speed, h);
      if (u > 12.0) u = 12.0;
      if (u < -12.0) u = -12.0;
      if (std::fabs(u) < 0.6) u = 0;          // deadband (motors.cpp:150)
      // crude first-order motor response toward commanded voltage
      double target = u / 12.0 * 12.0;        // rad/s at full voltage ~12
      m->speed += (target - m->speed) * std::fmin(1.0, h * 8.0);
      double dcounts = m->speed * h / (2 * M_PI) * counts_per_rev;
      m->odom_accum += dcounts;
    }
    // integrate chassis pose from wheel speeds
    double vl = left.speed * wheel_radius;
    double vr = right.speed * wheel_radius;
    double v = (vl + vr) / 2, om = (vr - vl) / wheel_distance;
    theta += om * h;
    x += v * h * std::cos(theta);
    y += v * h * std::sin(theta);
  }

  double raycast(double angle) const {
    double dx = std::cos(angle), dy = std::sin(angle);
    double best = max_range_m;
    for (size_t i = 0; i + 3 < segs.size(); i += 4) {
      double ax = segs[i], ay = segs[i + 1];
      double bx = segs[i + 2] - ax, by = segs[i + 3] - ay;
      double den = bx * dy - by * dx;
      if (std::fabs(den) < 1e-12) continue;
      double aox = ax - x, aoy = ay - y;
      double t = (aoy * bx - aox * by) / den;
      double u = (dx * aoy - dy * aox) / den;
      if (t > 1e-6 && u >= 0 && u <= 1 && t < best) best = t;
    }
    return best;
  }

  // Home the turret (sensor.cpp:247-276): the firmware steps until the IR
  // photo-interrupter peak.  Modeled as rotating the turret the remaining
  // steps back to index 0 at the 800 us/step stepper rate, with the motor
  // loop advancing during the sweep (chassis keeps moving while homing).
  void home() {
    int remaining = (steps_per_rev - turret_step) % steps_per_rev;
    double sweep_time = remaining * 0.0008;          // step_motor: 800 us
    for (double t = 0; t < sweep_time; t += 0.01) motor_tick(0.01);
    turret_step = 0;
  }

  // TFMini signal strength model: inversely distance-like, the shape real
  // units exhibit (spec floor 20, saturation ~3000).
  int16_t strength_of(double d) {
    double s = 3000.0 / (1.0 + d * d);
    if (s < 20.0) s = 20.0;
    if (s > 3000.0) s = 3000.0;
    return static_cast<int16_t>(s);
  }

  // Generate one full sensor revolution worth of wire packets into `out`,
  // advancing the simulation (sensor.cpp:114-230: one TFmini reading per
  // stepper step at ~100 Hz, then the steps<0 odometry marker).  The `back`
  // field carries the TFMini strength (the slot the ARDUINO generation used
  // for its second sensor, ARDUINO_SKETCH.ino:147-199).
  void revolution(std::vector<uint8_t>* out, double range_noise_sd) {
    int step_inc = degrees_per_step * steps_per_rev / 360;
    double h = 0.01;                       // 100 Hz sensor+motor cadence
    for (int n = 0; n < steps_per_rev / step_inc; ++n) {
      int s = turret_step;
      motor_tick(h);
      double beam = theta - M_PI / 2 +
                    s * (2 * M_PI / steps_per_rev);  // SENSOR_ANGLE_OFFSET
      double d = raycast(beam);
      int16_t mm, strength;
      if (d >= max_range_m - 1e-9) {
        mm = -1;                           // no-response sentinel (<0 ⇒ miss)
        strength = 0;
      } else {
        d += range_noise_sd * nrand();
        if (d < 0.01) d = 0.01;
        mm = static_cast<int16_t>(d * 1000.0 + 0.5);
        strength = strength_of(d);
      }
      Packet p{kMagic, static_cast<int16_t>(s), mm, strength};
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&p);
      out->insert(out->end(), b, b + sizeof(Packet));
      turret_step = (turret_step + step_inc) % steps_per_rev;
    }
    // odometry marker: counts since last marker (sensor.cpp:188-194)
    for (Motor* m : {&left, &right}) {
      m->odom_counter = static_cast<int32_t>(m->odom_accum);
      m->odom_accum -= m->odom_counter;
    }
    Packet marker{kMagic, -1, static_cast<int16_t>(left.odom_counter),
                  static_cast<int16_t>(right.odom_counter)};
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&marker);
    out->insert(out->end(), b, b + sizeof(Packet));
  }
};

}  // namespace

// ----------------------------------------------------------------- C ABI
extern "C" {

// ---- codec ----
int gs_encode_measurement(int16_t steps, int16_t front, int16_t back,
                          uint8_t out[8]) {
  Packet p{kMagic, steps, front, back};
  std::memcpy(out, &p, 8);
  return 8;
}

// ---- streaming parser ----
void* gs_parser_new() { return new Parser(); }
void gs_parser_free(void* p) { delete static_cast<Parser*>(p); }
void gs_parser_feed(void* p, const uint8_t* data, int n) {
  static_cast<Parser*>(p)->feed(data, static_cast<size_t>(n));
}
int gs_parser_pending(void* p) {
  return static_cast<int>(static_cast<Parser*>(p)->done.size());
}
// Pops the oldest complete revolution. Returns #measurements written, or -1
// if none pending. steps/front/back arrays must hold >= 720 entries.
// `back` receives the packet's 4th field: TFMini signal strength on the
// current firmware, the rear VL53L1X distance on the ARDUINO generation
// (SURVEY.md section 2.7); pass NULL to drop it.
int gs_parser_pop(void* p, int16_t* steps, int16_t* front_mm, int16_t* back,
                  int16_t* left_count, int16_t* right_count) {
  Parser* ps = static_cast<Parser*>(p);
  if (ps->done.empty()) return -1;
  Revolution& r = ps->done.front();
  int n = static_cast<int>(r.meas.size());
  if (n > kMaxSteps) n = kMaxSteps;
  for (int i = 0; i < n; ++i) {
    steps[i] = r.meas[i].steps;
    front_mm[i] = r.meas[i].front_mm;
    if (back) back[i] = r.meas[i].back;
  }
  *left_count = r.left_count;
  *right_count = r.right_count;
  ps->done.erase(ps->done.begin());
  return n;
}

// ---- TFMini 9-byte UART frame codec (TFmini.h:230-315) ----
int gs_tfmini_encode(uint16_t dist, uint16_t strength, uint8_t int_time,
                     uint8_t out[9]) {
  out[0] = kTfHeader; out[1] = kTfHeader;
  out[2] = dist & 0xFF; out[3] = dist >> 8;
  out[4] = strength & 0xFF; out[5] = strength >> 8;
  out[6] = int_time; out[7] = 0;
  uint32_t sum = 0;
  for (int i = 0; i < 8; ++i) sum += out[i];
  out[8] = static_cast<uint8_t>(sum);
  return 9;
}

void* gs_tfmini_new() { return new TfDecoder(); }
void gs_tfmini_free(void* d) { delete static_cast<TfDecoder*>(d); }
void gs_tfmini_feed(void* d, const uint8_t* data, int n) {
  static_cast<TfDecoder*>(d)->feed(data, static_cast<size_t>(n));
}
int gs_tfmini_pending(void* d) {
  return static_cast<int>(static_cast<TfDecoder*>(d)->done.size());
}
// Returns 1 and fills dist/strength/int_time, or 0 if none pending.
int gs_tfmini_pop(void* d, uint16_t* dist, uint16_t* strength,
                  uint8_t* int_time) {
  TfDecoder* td = static_cast<TfDecoder*>(d);
  if (td->done.empty()) return 0;
  TfReading r = td->done.front();
  td->done.erase(td->done.begin());
  *dist = r.dist; *strength = r.strength; *int_time = r.int_time;
  return 1;
}

// ---- command encoding (ConnectionManager.java:40-44,185-229) ----
int gs_encode_command(uint8_t cmd, uint8_t* out) { out[0] = cmd; return 1; }
int gs_encode_set_resolution(uint8_t degrees, uint8_t* out) {
  out[0] = 0x08; out[1] = degrees; return 2;
}
static void put_f32_be(float v, uint8_t* out) {
  uint32_t u; std::memcpy(&u, &v, 4);
  out[0] = u >> 24; out[1] = u >> 16; out[2] = u >> 8; out[3] = u;
}
int gs_encode_wheel_speeds(float left, float right, uint8_t* out) {
  out[0] = 0x10; put_f32_be(left, out + 1); put_f32_be(right, out + 5);
  return 9;
}
int gs_encode_pid_gain(uint8_t which /*0x15..0x18*/, float v, uint8_t* out) {
  out[0] = which; put_f32_be(v, out + 1); return 5;
}

// ---- robot simulator ----
void* gs_sim_new(const double* segs, int n_segs, double x, double y,
                 double theta, uint32_t seed) {
  Sim* s = new Sim();
  s->segs.assign(segs, segs + 4 * n_segs);
  s->x = x; s->y = y; s->theta = theta;
  s->rng = seed ? seed : 1;
  return s;
}
void gs_sim_free(void* s) { delete static_cast<Sim*>(s); }
void gs_sim_set_speeds(void* s, double left_ref, double right_ref) {
  Sim* sim = static_cast<Sim*>(s);
  sim->left.reference = left_ref;
  sim->right.reference = right_ref;
}
void gs_sim_set_resolution(void* s, int degrees) {
  static_cast<Sim*>(s)->degrees_per_step = degrees;
}
// Command 0x05: home the sensor turret (esp32/sensor.cpp:247-276).
void gs_sim_home(void* s) { static_cast<Sim*>(s)->home(); }
// Current turret step index (for tests of homing behavior).
int gs_sim_turret_step(void* s) { return static_cast<Sim*>(s)->turret_step; }
void gs_sim_pose(void* s, double* xyz) {
  Sim* sim = static_cast<Sim*>(s);
  xyz[0] = sim->x; xyz[1] = sim->y; xyz[2] = sim->theta;
}
// Runs one sensor revolution; writes wire bytes to out (caller buffer of at
// least 8*(720+1) bytes); returns byte count.
int gs_sim_revolution(void* s, uint8_t* out, int out_cap,
                      double range_noise_sd) {
  std::vector<uint8_t> bytes;
  static_cast<Sim*>(s)->revolution(&bytes, range_noise_sd);
  int n = static_cast<int>(bytes.size());
  if (n > out_cap) n = out_cap;
  std::memcpy(out, bytes.data(), n);
  return n;
}

// ---------------------------------------------------------------------------
// Recording-file reader: the reference's big-endian replay-log format
// (app/DataRecorder.java:381-436 + app/ObjectSerializer.java:36-83):
//   u8 0xFF; i16 N; N x { f32 t; f64 dCenter; f64 dTheta;
//                         i16 M; M x { f64 angle; f64 dist; u8 wasHit } }
// The native data-loader counterpart of io/recording.py's Python reader
// (byte-exact; regression-tested against it in tests/test_native.py).

static inline uint16_t gs_be16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}
static inline uint32_t gs_be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}
static inline uint64_t gs_be64(const uint8_t* p) {
  return (static_cast<uint64_t>(gs_be32(p)) << 32) | gs_be32(p + 4);
}
static inline float gs_bef32(const uint8_t* p) {
  uint32_t v = gs_be32(p); float f; std::memcpy(&f, &v, 4); return f;
}
static inline double gs_bef64(const uint8_t* p) {
  uint64_t v = gs_be64(p); double d; std::memcpy(&d, &v, 8); return d;
}

// Pass 1: validate + size.  Returns 0 ok, -1 bad header, -2 truncated.
int gs_recording_scan(const uint8_t* data, long n, int* n_frames,
                      long* m_total) {
  if (n < 3 || data[0] != 0xFF) return -1;
  int nf = static_cast<int16_t>(gs_be16(data + 1));
  if (nf < 0) return -2;
  long off = 3, mt = 0;
  for (int i = 0; i < nf; i++) {
    if (off + 22 > n) return -2;
    int m = static_cast<int16_t>(gs_be16(data + off + 20));
    off += 22;
    if (m < 0 || off + static_cast<long>(m) * 17 > n) return -2;
    mt += m;
    off += static_cast<long>(m) * 17;
  }
  *n_frames = nf;
  *m_total = mt;
  return 0;
}

// Pass 2: parse into caller-allocated flat arrays (sizes from pass 1).
void gs_recording_parse(const uint8_t* data, long n, float* t,
                        double* d_center, double* d_theta, int* m_counts,
                        double* angle, double* dist, uint8_t* hit) {
  (void)n;  // bounds validated by gs_recording_scan
  int nf = static_cast<int16_t>(gs_be16(data + 1));
  long off = 3, k = 0;
  for (int i = 0; i < nf; i++) {
    t[i] = gs_bef32(data + off); off += 4;
    d_center[i] = gs_bef64(data + off); off += 8;
    d_theta[i] = gs_bef64(data + off); off += 8;
    int m = static_cast<int16_t>(gs_be16(data + off)); off += 2;
    m_counts[i] = m;
    for (int j = 0; j < m; j++, k++) {
      angle[k] = gs_bef64(data + off); off += 8;
      dist[k] = gs_bef64(data + off); off += 8;
      hit[k] = data[off]; off += 1;
    }
  }
}

}  // extern "C"
