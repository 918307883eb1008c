// gubernator-tpu native serving edge.
//
// The latency-critical front door the reference implements in compiled Go
// (its gRPC/JSON gateway): this C++ process terminates client HTTP/1.1
// JSON connections, validates + parses requests, coalesces them across
// ALL connections into micro-batches (the reference's BatchWait /
// BatchLimit semantics, config.go:59-62), and forwards each batch to the
// Python serving daemon as ONE binary frame over a unix-domain socket
// (serve/edge_bridge.py). The daemon pays one read + one decode per
// batch; all per-request parse/serialize cost stays here, outside the
// Python process. Responses fan back to the originating connections.
//
// Scope: POST /v1/GetRateLimits (the hot path). Everything else
// (HealthCheck, metrics, debug) is served by the daemon's own HTTP
// listener; GET /v1/HealthCheck here reports edge liveness only.
//
// Build: make -C gubernator_tpu/native/edge
// Run:   guber-edge --listen 8080 --backend /tmp/guber-edge.sock
//                   [--batch-wait-us 500] [--batch-limit 1000]

#include <arpa/inet.h>
#include <csignal>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <poll.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------- protocol

constexpr uint32_t kMagicReq = 0x31424547;       // 'GEB1'
constexpr uint32_t kMagicResp = 0x33424547;      // 'GEB3'
constexpr uint32_t kMagicHello = 0x49424547;     // 'GEBI' ring hello (r5)
constexpr uint32_t kMagicFastReq = 0x36424547;   // 'GEB6' pre-hashed (r5)
constexpr uint32_t kMagicFastResp = 0x35424547;  // 'GEB5'
constexpr uint32_t kMagicStale = 0x52424547;     // 'GEBR' stale ring
// windowed framing (r7): per-frame ids + a bridge-advertised credit
// window, so N frames ride one connection and responses complete out
// of order (serve/edge_bridge.py module docstring for the layouts)
constexpr uint32_t kMagicWReq = 0x32424547;       // 'GEB2' string req
constexpr uint32_t kMagicWResp = 0x34424547;      // 'GEB4' string resp
constexpr uint32_t kMagicWFastReq = 0x37424547;   // 'GEB7' fast req
constexpr uint32_t kMagicWFastResp = 0x38424547;  // 'GEB8' fast resp

// CLOCK_MONOTONIC microseconds — the same clock domain as the
// daemon's time.monotonic(), so a frame stamp crosses the socket
// intact and the bridge can attribute edge->bridge transit
// (serve/stages.py edge_to_bridge)
uint64_t mono_us() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// IPv6 bridge endpoint specs are refused loudly (ADVICE r5 #2): the
// frame protocol splits host:port on the LAST colon, so '[::1]:9100'
// or a bare '::1' would misparse silently (bracketed host handed to
// getaddrinfo, or the address mistaken for a unix path).
bool endpoint_is_ipv6ish(const std::string& s) {
  if (s.find('[') != std::string::npos ||
      s.find(']') != std::string::npos)
    return true;
  return std::count(s.begin(), s.end(), ':') > 1;
}

struct Item {
  std::string name;
  std::string key;
  int64_t hits = 0;
  int64_t limit = 0;
  int64_t duration = 0;
  uint8_t algorithm = 0;
  uint8_t behavior = 0;
  uint64_t hash = 0;  // xxh64(name+"_"+key) for the GEB4 fast path
};

// ------------------------------------------------------------------ xxh64
// XXH64 (Yann Collet's public-domain algorithm), implemented from the
// spec — MUST produce bit-identical values to native/guberhash.cc's
// implementation with the daemon's seed, or the edge's pre-hashed keys
// would address different store slots than directly-served traffic
// (pinned e2e by tests/test_edge_fast_path.py shared-state assertions).
constexpr uint64_t kSlotHashSeed = 0x67756265726E6174ULL;  // "gubernat"

uint64_t xx_rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

uint64_t xxh64(const uint8_t* data, size_t len, uint64_t seed) {
  constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
  constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
  constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
  constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
  constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;
  auto rd64 = [](const uint8_t* q) {
    uint64_t v;
    memcpy(&v, q, 8);
    return v;  // little-endian host assumed (x86/arm)
  };
  auto rd32 = [](const uint8_t* q) {
    uint32_t v;
    memcpy(&v, q, 4);
    return (uint64_t)v;
  };
  auto round = [](uint64_t acc, uint64_t input) {
    return xx_rotl(acc + input * P2, 31) * P1;
  };
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    do {
      v1 = round(v1, rd64(p)); p += 8;
      v2 = round(v2, rd64(p)); p += 8;
      v3 = round(v3, rd64(p)); p += 8;
      v4 = round(v4, rd64(p)); p += 8;
    } while (p + 32 <= end);
    h = xx_rotl(v1, 1) + xx_rotl(v2, 7) + xx_rotl(v3, 12) + xx_rotl(v4, 18);
    auto merge = [&](uint64_t acc, uint64_t val) {
      return (acc ^ round(0, val)) * P1 + P4;
    };
    h = merge(h, v1); h = merge(h, v2); h = merge(h, v3); h = merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h = xx_rotl(h ^ round(0, rd64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = xx_rotl(h ^ (rd32(p) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = xx_rotl(h ^ (*p++ * P5), 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

uint64_t slot_hash(const std::string& name, const std::string& key) {
  std::string joined;
  joined.reserve(name.size() + 1 + key.size());
  joined += name;
  joined += '_';
  joined += key;
  return xxh64((const uint8_t*)joined.data(), joined.size(), kSlotHashSeed);
}

// ------------------------------------------------------------------ crc32
// CRC-32 (IEEE 802.3, the zlib/Go crc32.ChecksumIEEE polynomial),
// table-driven, written from the spec. MUST match zlib.crc32: the ring
// places a key on the node whose point (crc32 of its gRPC address)
// succeeds crc32(name+"_"+key) — bit parity with the daemon's
// core/hashing.ring_hash (reference hash.go:40-42) is what makes the
// edge's routing agree with every daemon's picker (pinned e2e by
// tests/test_edge_cluster.py placement assertions).

struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
      t[i] = c;
    }
  }
};

uint32_t crc32_ieee(const uint8_t* p, size_t n) {
  static const Crc32Table tbl;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = tbl.t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t crc32_str(const std::string& s) {
  return crc32_ieee((const uint8_t*)s.data(), s.size());
}

// ------------------------------------------------------------------- ring
// Consistent-hash view of the cluster, read from the bridge hello
// (serve/edge_bridge.py `_hello`). Placement-compatible with the
// daemon's picker (serve/peers.py ConsistentHashPicker / reference
// hash.go:80-96): one crc32 point per node, sorted, successor with
// wraparound.

struct Node {
  std::string grpc;    // the node's gRPC address (ring point + owner
                       // metadata string)
  std::string bridge;  // "host:port" of its edge bridge; empty = reach
                       // it through the slow path (string frames to the
                       // primary, which forwards over gRPC)
  bool self = false;   // the node behind our --backend endpoint
};

struct Ring {
  uint32_t hash = 0;  // membership fingerprint; echoed in fast frames
  bool fast = false;  // bridge advertises the pre-hashed path
  bool windowed = false;  // bridge accepts GEB2/GEB7 windowed frames
  uint32_t window = 0;    // credit window (frames in flight per conn)
  std::vector<Node> nodes;
  std::vector<std::pair<uint32_t, int>> points;  // sorted (point, node)

  void index() {
    points.clear();
    for (size_t i = 0; i < nodes.size(); ++i)
      points.emplace_back(crc32_str(nodes[i].grpc), (int)i);
    std::sort(points.begin(), points.end());
    // two addresses on one crc32 point (~2^-32/pair) would split
    // ownership between this sort-order tie-break and the picker's
    // last-add-wins — and the membership fingerprint cannot catch it.
    // The daemon's picker refuses the collision; surface it here too
    // in case a version-skewed daemon let it through (ADVICE r5 #3).
    for (size_t i = 1; i < points.size(); ++i)
      if (points[i].first == points[i - 1].first)
        fprintf(stderr,
                "guber-edge: ring point collision %#x between '%s' and "
                "'%s'; placement may diverge from the daemons\n",
                points[i].first, nodes[points[i - 1].second].grpc.c_str(),
                nodes[points[i].second].grpc.c_str());
  }

  // node index owning `name_key`, or -1 on an empty ring
  int owner(const std::string& name, const std::string& key) const {
    if (points.empty()) return -1;
    std::string joined;
    joined.reserve(name.size() + 1 + key.size());
    joined += name;
    joined += '_';
    joined += key;
    uint32_t point = crc32_str(joined);
    auto it = std::lower_bound(
        points.begin(), points.end(),
        std::make_pair(point, INT32_MIN));
    if (it == points.end()) it = points.begin();
    return it->second;
  }
};

struct Decision {
  uint8_t status = 0;
  int64_t limit = 0;
  int64_t remaining = 0;
  int64_t reset_time = 0;
  std::string error;
  std::string owner;  // metadata["owner"] for forwarded keys (parity
  // with the gRPC/gateway surface, reference gubernator.go:151)
};

void put_u16(std::string& b, uint16_t v) { b.append((char*)&v, 2); }
void put_u32(std::string& b, uint32_t v) { b.append((char*)&v, 4); }
void put_i64(std::string& b, int64_t v) { b.append((char*)&v, 8); }

// ------------------------------------------------------------- minimal JSON
// Parser for the fixed GetRateLimitsReq schema; tolerant of whitespace,
// field order, string/number duality for int64 fields (the JSON gateway
// emits int64 as strings), and unknown fields (skipped).

struct JsonCursor {
  const char* p;
  const char* end;
  bool fail = false;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool eat(char c) {
    ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    return false;
  }
  bool parse_string(std::string& out) {
    ws();
    if (p >= end || *p != '"') return false;
    ++p;
    out.clear();
    while (p < end && *p != '"') {
      char c = *p++;
      if (c == '\\' && p < end) {
        char e = *p++;
        switch (e) {
          case 'n': out.push_back('\n'); break;
          case 't': out.push_back('\t'); break;
          case 'r': out.push_back('\r'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case 'u': {
            if (end - p < 4) return false;
            unsigned cp = 0;
            for (int i = 0; i < 4; ++i) {
              char h = *p++;
              cp <<= 4;
              if (h >= '0' && h <= '9') cp |= h - '0';
              else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
              else return false;
            }
            // UTF-8 encode (BMP only; surrogate pairs unsupported — the
            // rate-limit key space in practice is ASCII)
            if (cp < 0x80) out.push_back((char)cp);
            else if (cp < 0x800) {
              out.push_back((char)(0xC0 | (cp >> 6)));
              out.push_back((char)(0x80 | (cp & 0x3F)));
            } else {
              out.push_back((char)(0xE0 | (cp >> 12)));
              out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
              out.push_back((char)(0x80 | (cp & 0x3F)));
            }
            break;
          }
          default: out.push_back(e);
        }
      } else {
        out.push_back(c);
      }
    }
    if (p >= end) return false;
    ++p;  // closing quote
    return true;
  }
  bool parse_i64(int64_t& out) {
    ws();
    if (p < end && *p == '"') {  // gateway-style string int64
      std::string s;
      if (!parse_string(s)) return false;
      out = strtoll(s.c_str(), nullptr, 10);  // NUL-bounded copy
      return true;
    }
    // Bounded manual scan: the buffer is only NUL-terminated at the end
    // of the whole pipelined stream, so a bare strtoll(p) on a body
    // whose Content-Length truncates mid-number would silently absorb
    // digits from the NEXT pipelined request. Saturates like strtoll.
    const char* q = p;
    bool neg = false;
    if (q < end && (*q == '-' || *q == '+')) {
      neg = (*q == '-');
      ++q;
    }
    if (q >= end || *q < '0' || *q > '9') return false;
    const uint64_t lim =
        neg ? (uint64_t)INT64_MAX + 1 : (uint64_t)INT64_MAX;
    uint64_t v = 0;
    for (; q < end && *q >= '0' && *q <= '9'; ++q) {
      if (v <= (lim - (uint64_t)(*q - '0')) / 10) {
        v = v * 10 + (uint64_t)(*q - '0');
      } else {
        v = lim;  // saturate, keep consuming digits
      }
    }
    out = neg ? (v >= (uint64_t)INT64_MAX + 1
                     ? INT64_MIN
                     : -(int64_t)v)
              : (int64_t)v;
    p = q;
    return true;
  }
  // skip any value (for unknown fields)
  bool skip_value() {
    ws();
    if (p >= end) return false;
    if (*p == '"') {
      std::string s;
      return parse_string(s);
    }
    if (*p == '{' || *p == '[') {
      char open = *p, close = (open == '{') ? '}' : ']';
      int depth = 0;
      bool in_str = false;
      while (p < end) {
        char c = *p++;
        if (in_str) {
          if (c == '\\') { if (p < end) ++p; }
          else if (c == '"') in_str = false;
        } else if (c == '"') in_str = true;
        else if (c == open) ++depth;
        else if (c == close && --depth == 0) return true;
      }
      return false;
    }
    while (p < end && *p != ',' && *p != '}' && *p != ']') ++p;
    return true;
  }
};

bool field_is(const std::string& f, const char* snake, const char* camel) {
  return f == snake || f == camel;
}

// algorithm / behavior accept both enum names and numbers
uint8_t parse_algorithm(JsonCursor& c, bool& ok) {
  c.ws();
  if (c.p < c.end && *c.p == '"') {
    std::string s;
    ok = c.parse_string(s);
    return s == "LEAKY_BUCKET" ? 1 : 0;
  }
  int64_t v = 0;
  ok = c.parse_i64(v);
  return (uint8_t)v;
}

uint8_t parse_behavior(JsonCursor& c, bool& ok) {
  c.ws();
  if (c.p < c.end && *c.p == '"') {
    std::string s;
    ok = c.parse_string(s);
    if (s == "NO_BATCHING") return 1;
    if (s == "GLOBAL") return 2;
    return 0;
  }
  int64_t v = 0;
  ok = c.parse_i64(v);
  return (uint8_t)v;
}

// returns false on malformed JSON
bool parse_get_rate_limits(const char* body, size_t len,
                           std::vector<Item>& out) {
  JsonCursor c{body, body + len};
  if (!c.eat('{')) return false;
  std::string field;
  while (true) {
    if (c.eat('}')) return true;
    if (!c.parse_string(field) || !c.eat(':')) return false;
    if (field_is(field, "requests", "requests")) {
      if (!c.eat('[')) return false;
      if (c.eat(']')) { /* empty */ }
      else {
        do {
          if (!c.eat('{')) return false;
          Item it;
          std::string f;
          while (true) {
            if (c.eat('}')) break;
            if (!c.parse_string(f) || !c.eat(':')) return false;
            bool ok = true;
            if (field_is(f, "name", "name")) ok = c.parse_string(it.name);
            else if (field_is(f, "unique_key", "uniqueKey"))
              ok = c.parse_string(it.key);
            else if (field_is(f, "hits", "hits")) ok = c.parse_i64(it.hits);
            else if (field_is(f, "limit", "limit")) ok = c.parse_i64(it.limit);
            else if (field_is(f, "duration", "duration"))
              ok = c.parse_i64(it.duration);
            else if (field_is(f, "algorithm", "algorithm"))
              it.algorithm = parse_algorithm(c, ok);
            else if (field_is(f, "behavior", "behavior"))
              it.behavior = parse_behavior(c, ok);
            else ok = c.skip_value();
            if (!ok) return false;
            c.eat(',');
          }
          out.push_back(std::move(it));
        } while (c.eat(','));
        if (!c.eat(']')) return false;
      }
    } else {
      if (!c.skip_value()) return false;
    }
    c.eat(',');
  }
}

const char* kStatusName[2] = {"UNDER_LIMIT", "OVER_LIMIT"};

void json_escape(std::string& out, const std::string& s) {
  for (char ch : s) {
    switch (ch) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if ((unsigned char)ch < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", ch);
          out += buf;
        } else out.push_back(ch);
    }
  }
}

std::string render_responses(const Decision* d, size_t n) {
  std::string out = "{\"responses\": [";
  char num[32];
  for (size_t i = 0; i < n; ++i) {
    if (i) out += ", ";
    out += "{\"status\": \"";
    out += kStatusName[d[i].status & 1];
    out += "\", \"limit\": \"";
    snprintf(num, sizeof num, "%lld", (long long)d[i].limit);
    out += num;
    out += "\", \"remaining\": \"";
    snprintf(num, sizeof num, "%lld", (long long)d[i].remaining);
    out += num;
    out += "\", \"resetTime\": \"";
    snprintf(num, sizeof num, "%lld", (long long)d[i].reset_time);
    out += num;
    out += "\", \"error\": \"";
    json_escape(out, d[i].error);
    if (d[i].owner.empty()) {
      out += "\", \"metadata\": {}}";
    } else {
      out += "\", \"metadata\": {\"owner\": \"";
      json_escape(out, d[i].owner);
      out += "\"}}";
    }
  }
  out += "]}";
  return out;
}

// SIGTERM/SIGINT: stop accepting, let in-flight requests drain (bounded),
// exit 0 — the same graceful contract as the daemon (reference
// cmd/gubernator/main.go:127-139 drains on SIGINT). The handler writes
// one byte into a self-pipe the accept loops poll() on: process-directed
// signals may be delivered to ANY thread, so waking a specific blocked
// accept() via EINTR is not reliable (and stripping SA_RESTART would
// instead abort in-flight reads everywhere else).
std::atomic<bool> g_shutdown{false};
int g_wake_pipe[2] = {-1, -1};
int g_peer_timeout_s = 30;  // peer-bridge round-trip deadline (see Lane)

void on_term(int) {
  g_shutdown.store(true);
  if (g_wake_pipe[1] >= 0) {
    char b = 1;
    // async-signal-safe; a full pipe just means a wakeup is already queued
    (void)!write(g_wake_pipe[1], &b, 1);
  }
}

// ----------------------------------------------------------- lanes/router
// r5 cluster shape: one request (Pending) splits into SHARDS — one
// per-owner pre-hashed (GEB6) shard per cluster node, plus one string
// (GEB1) shard for items that need the serving instance's full
// semantics (GLOBAL, validation errors, nodes without a reachable
// bridge). Each shard rides a Lane: a batching connection pool to one
// bridge endpoint (the local unix socket, or a peer's TCP bridge).
// This is the reference's every-compiled-node-routes shape
// (gubernator.go:114, hash.go:80-96) applied to the edge tier.

struct Pending {
  std::vector<Item> items;
  std::vector<Decision> decisions;  // sized by Router::execute
  int shards_left = 0;
  std::mutex m;
  std::condition_variable cv;
};

struct Shard {
  Pending* parent = nullptr;
  std::vector<uint32_t> idx;  // positions in parent->items
  bool fast = false;          // GEB6 vs GEB1 framing
  uint32_t ring_hash = 0;     // membership view this shard was routed
                              // with (echoed in GEB6 frames)
  std::string owner;          // non-self owner's gRPC addr: stamped as
                              // metadata.owner on success (parity with
                              // instance-side forwards, instance.py)
  bool failed = false;
  bool stale = false;         // failed because the bridge refused the
                              // ring view (GEBR)
};

enum class RtStatus { kOk, kFail, kStale };

// Mark a shard finished. Decision/field writes above happen-before the
// parent's wakeup via p->m. Notify while holding p->m: the waiter may
// destroy the stack Pending the instant shards_left hits zero.
void finish_shard(Shard* s, RtStatus st) {
  if (st != RtStatus::kOk) {
    s->failed = true;
    s->stale = (st == RtStatus::kStale);
  }
  Pending* p = s->parent;
  std::lock_guard<std::mutex> lk(p->m);
  if (--p->shards_left == 0) p->cv.notify_one();
}

// A condition wait that names itself once it has lasted over a second:
// one stderr line "guber-edge: wait '<name>' over 1 s: <what()>" a
// wait, then it goes on waiting exactly as cv.wait(lk, pred) does. The
// lane and credit waits use it, so a wait that never ends is named by
// the log (the stall a host can hide from every other tool).
template <class Pred, class What>
void wait_logged(std::condition_variable& cv, std::unique_lock<std::mutex>& lk,
                 Pred pred, const char* name, What what) {
  if (cv.wait_for(lk, std::chrono::seconds(1), pred)) return;
  std::string why = what();
  fprintf(stderr, "guber-edge: wait '%s' over 1 s: %s\n", name, why.c_str());
  cv.wait(lk, pred);
}

// A blocking socket call that names itself when it took over a second:
// once it returns, one stderr line "guber-edge: call '<name>' over 1 s:
// <ms> ms on fd <fd>, rc <rc>, errno <errno>"; errno is kept for the
// caller. Only calls that no idle peer explains use it: the accept loops'
// accept (after poll found a connection waiting), the client connection
// threads' writes, and their reads once part of a request or frame has
// arrived. The accept loops' poll and the first read of a request or
// frame wait on a quiet listener or keep-alive peer and are not timed.
// So a call the host holds is named the way wait_logged names a wait.
template <class Call>
auto call_logged(const char* name, int fd, Call call) -> decltype(call()) {
  auto t0 = std::chrono::steady_clock::now();
  auto rc = call();
  int err = errno;
  long long ms = std::chrono::duration_cast<std::chrono::milliseconds>(
                     std::chrono::steady_clock::now() - t0)
                     .count();
  if (ms > 1000) {
    fprintf(stderr, "guber-edge: call '%s' over 1 s: %lld ms on fd %d, rc %lld, errno %d\n",
            name, ms, fd, (long long)rc, rc < 0 ? err : 0);
  }
  errno = err;
  return rc;
}

// Bridge endpoint: a unix path (the co-located daemon) or host:port (a
// peer's TCP bridge listener).
struct Endpoint {
  bool is_unix = true;
  std::string path;  // unix path, or host
  uint16_t port = 0;
  std::string spec;  // the original string (lane registry key)
};

Endpoint parse_endpoint(const std::string& s) {
  Endpoint ep;
  ep.spec = s;
  size_t colon = s.rfind(':');
  if (colon != std::string::npos && colon + 1 < s.size()) {
    bool digits = true;
    for (size_t i = colon + 1; i < s.size(); ++i)
      if (s[i] < '0' || s[i] > '9') digits = false;
    if (digits) {
      ep.is_unix = false;
      ep.path = s.substr(0, colon);
      ep.port = (uint16_t)atoi(s.c_str() + colon + 1);
      return ep;
    }
  }
  ep.path = s;
  return ep;
}

// Connect with a bounded handshake: TCP connects are non-blocking with
// a 5s poll (a peer that fell off the network must cost one failed
// shard, not a 2-minute SYN timeout holding client requests hostage).
int connect_endpoint(const Endpoint& ep) {
  int fd;
  if (ep.is_unix) {
    fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_un addr{};
    addr.sun_family = AF_UNIX;
    snprintf(addr.sun_path, sizeof addr.sun_path, "%s", ep.path.c_str());
    if (connect(fd, (sockaddr*)&addr, sizeof addr) != 0) {
      close(fd);
      return -1;
    }
    return fd;
  }
  addrinfo hints{};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  char portbuf[8];
  snprintf(portbuf, sizeof portbuf, "%u", (unsigned)ep.port);
  if (getaddrinfo(ep.path.c_str(), portbuf, &hints, &res) != 0 || !res)
    return -1;
  fd = socket(res->ai_family, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) {
    freeaddrinfo(res);
    return -1;
  }
  int rc = connect(fd, res->ai_addr, (socklen_t)res->ai_addrlen);
  freeaddrinfo(res);
  if (rc != 0 && errno == EINPROGRESS) {
    pollfd pfd{fd, POLLOUT, 0};
    if (poll(&pfd, 1, 5000) <= 0) rc = -1;
    else {
      int err = 0;
      socklen_t elen = sizeof err;
      getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &elen);
      rc = err == 0 ? 0 : -1;
    }
  } else if (rc != 0) {
    rc = -1;
  }
  if (rc != 0) {
    close(fd);
    return -1;
  }
  int fl = fcntl(fd, F_GETFL);
  fcntl(fd, F_SETFL, fl & ~O_NONBLOCK);
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  return fd;
}

bool send_all(int fd, const char* p, size_t n) {
  while (n) {
    ssize_t w = write(fd, p, n);
    if (w < 0 && errno == EINTR) continue;  // signal mid-roundtrip
    if (w <= 0) return false;
    p += w;
    n -= (size_t)w;
  }
  return true;
}
bool recv_all(int fd, char* p, size_t n) {
  while (n) {
    ssize_t r = read(fd, p, n);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

// Ring-carrying hello ('GEBI', serve/edge_bridge.py `_hello`). The fd
// must already have a receive deadline set; on success the deadline is
// the caller's to clear.
bool read_hello(int fd, Ring* out) {
  char hdr[16];
  if (!recv_all(fd, hdr, 16)) return false;
  uint32_t magic, flags, rhash, n_nodes;
  memcpy(&magic, hdr, 4);
  memcpy(&flags, hdr + 4, 4);
  memcpy(&rhash, hdr + 8, 4);
  memcpy(&n_nodes, hdr + 12, 4);
  if (magic != kMagicHello || n_nodes > 65536) return false;
  out->fast = (flags & 1) != 0;
  out->windowed = (flags & 2) != 0;
  out->window = flags >> 16;
  if (out->windowed && out->window == 0) out->window = 1;
  if (out->window > 1024) out->window = 1024;
  out->hash = rhash;
  out->nodes.clear();
  for (uint32_t i = 0; i < n_nodes; ++i) {
    char fix[3];
    if (!recv_all(fd, fix, 3)) return false;
    Node nd;
    nd.self = fix[0] != 0;
    uint16_t glen;
    memcpy(&glen, fix + 1, 2);
    nd.grpc.resize(glen);
    if (glen && !recv_all(fd, nd.grpc.data(), glen)) return false;
    uint16_t blen;
    if (!recv_all(fd, (char*)&blen, 2)) return false;
    nd.bridge.resize(blen);
    if (blen && !recv_all(fd, nd.bridge.data(), blen)) return false;
    if (!nd.bridge.empty() && endpoint_is_ipv6ish(nd.bridge)) {
      // a misparsed endpoint would dial garbage; treat the node as
      // bridge-less (its items ride the string path) and say so once
      fprintf(stderr,
              "guber-edge: ignoring IPv6 bridge endpoint '%s' for node "
              "'%s' (bridge endpoints must be IPv4/hostname)\n",
              nd.bridge.c_str(), nd.grpc.c_str());
      nd.bridge.clear();
    }
    out->nodes.push_back(std::move(nd));
  }
  out->index();
  return true;
}

class Lane : public std::enable_shared_from_this<Lane> {
 public:
  // `workers` connections to ONE bridge endpoint pull batches from a
  // shared queue, so batch N+1 is in flight while N awaits its
  // response. Ordering across concurrent batches is no more defined
  // than the reference's concurrent goroutines — per-connection HTTP
  // pipelining stays FIFO.
  //
  // Windowed mode (r7): when the bridge's hello advertises a credit
  // window, each worker connection splits into this writer thread and
  // a detached reader thread. The writer streams frames (each stamped
  // with a frame id + send time) without waiting for responses, up to
  // `window` in flight; the reader matches responses by id — possibly
  // out of order — and finishes their shards. Edge encode/decode of
  // frame N+1 overlaps the bridge's device wait on frame N, which is
  // where the one-frame-per-roundtrip protocol burned its wall time.
  //
  // Lifetime: created through create() only. Worker threads are
  // detached and co-own the Lane via shared_ptr, so an evicted lane
  // (membership churn dropped its endpoint) is freed when its last
  // worker observes `stopping_` and exits — nobody ever joins a
  // thread that may be blocked on a wedged peer. Readers co-own the
  // Lane and their connection state the same way.
  using HelloFn = std::function<void(const Ring&)>;

  static std::shared_ptr<Lane> create(Endpoint ep, int batch_wait_us,
                                      int batch_limit, int workers,
                                      HelloFn on_hello,
                                      bool wait_connect) {
    std::shared_ptr<Lane> lane(new Lane(std::move(ep), batch_wait_us,
                                        batch_limit,
                                        std::move(on_hello)));
    for (int i = 0; i < workers; ++i)
      std::thread([lane] { lane->run(); }).detach();
    // primary lane: block until every worker attempted its eager
    // connect, so a readiness probe hitting HealthCheck right after
    // the listen port opens sees the true backend state. Peer lanes
    // skip the wait — a request must not stall on a peer's SYN.
    if (wait_connect)
      while (lane->started_.load() < workers)
        std::this_thread::sleep_for(std::chrono::milliseconds(1));
    return lane;
  }

  // enqueue only; completion flows through finish_shard. Fast
  // (pre-hashed) and slow (string) shards ride separate queues: a
  // backend frame is all-GEB6 or all-GEB1. Returns false when the
  // lane is shutting down (the caller fails the shard).
  bool submit(Shard* s) {
    {
      std::lock_guard<std::mutex> lk(m_);
      if (stopping_) return false;
      (s->fast ? fast_queue_ : queue_).push_back(s);
      queued_items_ += s->idx.size();
    }
    cv_.notify_one();
    return true;
  }

  // Fail everything queued and tell the workers to exit after their
  // in-flight round-trips. Idempotent.
  void shutdown() {
    std::vector<Shard*> orphans;
    {
      std::lock_guard<std::mutex> lk(m_);
      if (stopping_) return;
      stopping_ = true;
      orphans.insert(orphans.end(), queue_.begin(), queue_.end());
      orphans.insert(orphans.end(), fast_queue_.begin(),
                     fast_queue_.end());
      queue_.clear();
      fast_queue_.clear();
      queued_items_ = 0;
    }
    cv_.notify_all();
    for (Shard* s : orphans) finish_shard(s, RtStatus::kFail);
  }

  bool backend_ok() const { return connected_.load() > 0; }

  // The lane's state for a wait's log line: its endpoint, the items
  // queued, and its workers waiting for work (idle) or holding a batch
  // (busy: sending, in a round-trip, or at the credit gate).
  std::string describe() {
    std::lock_guard<std::mutex> lk(m_);
    return "lane " + ep_.spec + " queued_items=" + std::to_string(queued_items_) +
           " shards=" + std::to_string(queue_.size() + fast_queue_.size()) +
           " workers_idle=" + std::to_string(n_idle_) +
           " workers_busy=" + std::to_string(n_busy_) +
           " connected=" + std::to_string(connected_.load()) +
           (stopping_ ? " stopping" : "");
  }
  // last hello's fast-path capability; false until the first connect
  bool fast_advertised() const { return fast_ok_.load(); }

 private:
  Lane(Endpoint ep, int batch_wait_us, int batch_limit,
       HelloFn on_hello)
      : ep_(std::move(ep)),
        wait_us_(batch_wait_us),
        limit_(batch_limit),
        on_hello_(std::move(on_hello)) {}
  int connect_backend() {
    int fd = connect_endpoint(ep_);
    if (fd < 0) return -1;
    // bounded hello read so a wedged bridge can't hang the worker
    timeval tv{};
    tv.tv_sec = 5;
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    Ring ring;
    if (!read_hello(fd, &ring)) {
      close(fd);
      return -1;
    }
    fast_ok_.store(ring.fast);
    windowed_.store(ring.windowed);
    window_.store(ring.windowed ? (int)ring.window : 0);
    if (on_hello_) on_hello_(ring);
    if (ep_.is_unix) {
      // co-located daemon: no steady-state deadline (pre-r5 contract;
      // a wedged local daemon takes the whole node down regardless)
      tv.tv_sec = 0;
      tv.tv_usec = 0;
    } else {
      // PEER round-trips stay bounded: a peer that accepts a frame and
      // never answers (half-open connection, wedged process) must cost
      // one failed shard — not permanently absorb this worker while
      // Router::execute waits forever and client connections pile up
      // to the max-conns cap. Steady-state decides are milliseconds
      // (rungs precompile at boot), so the default 30s is generous;
      // --peer-timeout-s tunes it for slower device backends.
      tv.tv_sec = g_peer_timeout_s;
      tv.tv_usec = 0;
      setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
    }
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    return fd;
  }

  // ---- frame builders / response fillers, shared by the one-frame
  // round-trip path (version-skewed bridges) and the windowed path ----

  static uint32_t build_fast_payload(const std::vector<Shard*>& batch,
                                     std::string& payload) {
    uint32_t n = 0;
    for (Shard* s : batch) {
      for (uint32_t i : s->idx) {
        const Item& it = s->parent->items[i];
        payload.append((const char*)&it.hash, 8);
        put_i64(payload, it.hits);
        put_i64(payload, it.limit);
        put_i64(payload, it.duration);
        payload.push_back((char)it.algorithm);
        ++n;
      }
    }
    return n;
  }

  static uint32_t build_string_payload(const std::vector<Shard*>& batch,
                                       std::string& payload) {
    uint32_t n = 0;
    for (Shard* s : batch) {
      for (uint32_t i : s->idx) {
        const Item& it = s->parent->items[i];
        put_u16(payload, (uint16_t)it.name.size());
        payload += it.name;
        put_u16(payload, (uint16_t)it.key.size());
        payload += it.key;
        put_i64(payload, it.hits);
        put_i64(payload, it.limit);
        put_i64(payload, it.duration);
        payload.push_back((char)it.algorithm);
        payload.push_back((char)it.behavior);
        ++n;
      }
    }
    return n;
  }

  static void fill_fast_decisions(std::vector<Shard*>& batch,
                                  const char* raw) {
    size_t off = 0;
    for (Shard* s : batch) {
      for (uint32_t i : s->idx) {
        Decision& d = s->parent->decisions[i];
        const char* rec = raw + off * 25;
        d.status = (uint8_t)rec[0];
        memcpy(&d.limit, rec + 1, 8);
        memcpy(&d.remaining, rec + 9, 8);
        memcpy(&d.reset_time, rec + 17, 8);
        if (!s->owner.empty()) d.owner = s->owner;
        ++off;
      }
    }
  }

  static bool read_string_decisions(int fd, uint32_t rn,
                                    std::vector<Decision>& all) {
    // wire count is attacker/desync-controlled on the windowed path
    // (the roundtrip caller checks rn==n first, kMagicWResp cannot
    // until the id lookup below the read): bound the allocation the
    // same way the GEB8 branch bounds its 25-byte records, else a
    // corrupt count bad_allocs a detached reader thread and
    // std::terminate takes the whole edge down. 29 = min bytes/record.
    if (rn > (64u << 20) / 29) return false;
    all.assign(rn, Decision());
    for (uint32_t i = 0; i < rn; ++i) {
      char fix[25];
      if (!recv_all(fd, fix, 25)) return false;
      all[i].status = (uint8_t)fix[0];
      memcpy(&all[i].limit, fix + 1, 8);
      memcpy(&all[i].remaining, fix + 9, 8);
      memcpy(&all[i].reset_time, fix + 17, 8);
      uint16_t elen;
      if (!recv_all(fd, (char*)&elen, 2)) return false;
      all[i].error.resize(elen);
      if (elen && !recv_all(fd, all[i].error.data(), elen)) return false;
      uint16_t olen;
      if (!recv_all(fd, (char*)&olen, 2)) return false;
      all[i].owner.resize(olen);
      if (olen && !recv_all(fd, all[i].owner.data(), olen)) return false;
    }
    return true;
  }

  static void fill_string_decisions(std::vector<Shard*>& batch,
                                    std::vector<Decision>& all) {
    size_t off = 0;
    for (Shard* s : batch) {
      for (uint32_t i : s->idx) {
        Decision& d = s->parent->decisions[i];
        d = std::move(all[off++]);
        // per-owner slow shards (r7): stamp the routed owner when the
        // serving node left it empty (it owned the key) — parity with
        // instance-side forwards and the fast path. A node that
        // re-forwarded a stale-routed item sets its own owner; keep it.
        if (d.owner.empty() && !s->owner.empty()) d.owner = s->owner;
      }
    }
  }

  // GEB6/GEB5: fixed 33-byte pre-hashed items out, 25-byte decisions
  // back — the daemon side is a single numpy structured-array view, so
  // per-item cost exists ONLY in this process. A GEBR reply means the
  // bridge's membership view differs from the one these shards were
  // routed with: fail them kStale (the router refreshes its ring).
  RtStatus roundtrip_fast(int fd, std::vector<Shard*>& batch) {
    std::string payload;
    uint32_t n = build_fast_payload(batch, payload);
    std::string frame;
    put_u32(frame, kMagicFastReq);
    put_u32(frame, n);
    put_u32(frame, batch[0]->ring_hash);  // batches share one view
    put_u32(frame, (uint32_t)payload.size());
    frame += payload;
    if (!send_all(fd, frame.data(), frame.size())) return RtStatus::kFail;

    char hdr[8];
    if (!recv_all(fd, hdr, 8)) return RtStatus::kFail;
    uint32_t magic, rn;
    memcpy(&magic, hdr, 4);
    memcpy(&rn, hdr + 4, 4);
    if (magic == kMagicStale) return RtStatus::kStale;
    if (magic != kMagicFastResp || rn != n) return RtStatus::kFail;
    std::vector<char> raw(25u * rn);
    if (rn && !recv_all(fd, raw.data(), raw.size()))
      return RtStatus::kFail;
    fill_fast_decisions(batch, raw.data());
    return RtStatus::kOk;
  }

  RtStatus roundtrip(int fd, std::vector<Shard*>& batch) {
    std::string payload;
    uint32_t n = build_string_payload(batch, payload);
    std::string frame;
    put_u32(frame, kMagicReq);
    put_u32(frame, n);
    put_u32(frame, (uint32_t)payload.size());
    frame += payload;
    if (!send_all(fd, frame.data(), frame.size())) return RtStatus::kFail;

    char hdr[8];
    if (!recv_all(fd, hdr, 8)) return RtStatus::kFail;
    uint32_t magic, rn;
    memcpy(&magic, hdr, 4);
    memcpy(&rn, hdr + 4, 4);
    if (magic != kMagicResp || rn != n) return RtStatus::kFail;
    std::vector<Decision> all;
    if (!read_string_decisions(fd, rn, all)) return RtStatus::kFail;
    fill_string_decisions(batch, all);
    return RtStatus::kOk;
  }

  // ---- windowed connection state (r7) ----
  // Co-owned by the writer worker and its detached reader thread; the
  // last owner's destructor closes the fd. kill() (shutdown both
  // directions) is safe to call while the other thread is blocked on
  // the fd — it unblocks reads without invalidating the descriptor.
  struct ConnState {
    int fd = -1;
    std::mutex m;
    std::condition_variable cv;
    struct Entry {
      std::vector<Shard*> batch;
      bool fast = false;
      uint32_t n = 0;
      // when the frame was registered: the reader's receive timeout
      // must measure the oldest frame's OWN wait, not an idle-parked
      // countdown a fresh frame happened to inherit
      std::chrono::steady_clock::time_point sent{};
    };
    std::unordered_map<uint32_t, Entry> inflight;  // frame_id -> entry
    bool dead = false;                             // guarded by m
    ~ConnState() {
      if (fd >= 0) close(fd);
    }
    void kill() { ::shutdown(fd, SHUT_RDWR); }
  };

  // Fail every frame still in flight (connection died, stream
  // desynced, or GEBR refused the routed view). Entries the writer
  // reclaimed on a failed send are already gone from the map, so no
  // shard is ever finished twice.
  static void drain_windowed(const std::shared_ptr<ConnState>& st,
                             RtStatus rst) {
    std::vector<ConnState::Entry> orphans;
    {
      std::lock_guard<std::mutex> lk(st->m);
      st->dead = true;
      for (auto& kv : st->inflight)
        orphans.push_back(std::move(kv.second));
      st->inflight.clear();
    }
    st->cv.notify_all();
    for (auto& e : orphans)
      for (Shard* s : e.batch) finish_shard(s, rst);
  }

  // Reader thread: match windowed responses to in-flight frames by id
  // (out-of-order completion is the point), finish their shards, and
  // release writer credit. Any protocol surprise or read failure kills
  // the connection and fails whatever is still outstanding. On peer
  // connections SO_RCVTIMEO bounds a wedged bridge; a timeout with
  // NOTHING in flight is just an idle connection and keeps waiting.
  void reader_loop(std::shared_ptr<ConnState> st) {
    auto recv_exact = [&](char* p, size_t nbytes, bool idle_ok) -> bool {
      size_t got = 0;
      while (got < nbytes) {
        ssize_t r = read(st->fd, p + got, nbytes - got);
        if (r > 0) {
          got += (size_t)r;
          continue;
        }
        if (r < 0 && errno == EINTR) continue;
        if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK) &&
            idle_ok && got == 0) {
          bool keep_waiting;
          {
            std::lock_guard<std::mutex> lk(st->m);
            if (st->dead) {
              keep_waiting = false;
            } else if (st->inflight.empty()) {
              keep_waiting = true;  // healthy idle conn: keep parking
            } else {
              // the SO_RCVTIMEO countdown that just expired mostly
              // measured idle time if a frame was sent moments ago —
              // only declare the bridge wedged once the OLDEST
              // in-flight frame has itself waited out the timeout
              auto oldest =
                  std::chrono::steady_clock::time_point::max();
              for (const auto& kv : st->inflight)
                if (kv.second.sent < oldest) oldest = kv.second.sent;
              keep_waiting = std::chrono::steady_clock::now() - oldest <
                             std::chrono::seconds(g_peer_timeout_s);
            }
          }
          if (keep_waiting) continue;
        }
        return false;
      }
      return true;
    };
    std::vector<char> raw;
    RtStatus fail_as = RtStatus::kFail;
    while (true) {
      char hdr[8];
      if (!recv_exact(hdr, 8, /*idle_ok=*/true)) break;
      uint32_t magic, second;
      memcpy(&magic, hdr, 4);
      memcpy(&second, hdr + 4, 4);
      if (magic == kMagicStale) {
        // second = the refused frame id; every outstanding frame was
        // routed with the same stale view, so they all fail kStale
        // (the router wakes its refresher)
        fail_as = RtStatus::kStale;
        break;
      }
      char fidb[4];
      uint32_t fid;
      if (magic == kMagicWFastResp) {
        if (!recv_exact(fidb, 4, false)) break;
        memcpy(&fid, fidb, 4);
        if (second > (uint32_t)(64 << 20) / 25) break;  // absurd count
        raw.resize((size_t)25 * second);
        if (second && !recv_exact(raw.data(), raw.size(), false)) break;
        ConnState::Entry e;
        bool ok = false;
        {
          std::lock_guard<std::mutex> lk(st->m);
          auto it = st->inflight.find(fid);
          if (it != st->inflight.end() && it->second.fast &&
              it->second.n == second) {
            e = std::move(it->second);
            st->inflight.erase(it);
            ok = true;
          }
        }
        if (!ok) break;  // unknown id / kind mismatch: stream desynced
        st->cv.notify_all();
        fill_fast_decisions(e.batch, raw.data());
        for (Shard* s : e.batch) finish_shard(s, RtStatus::kOk);
        continue;
      }
      if (magic == kMagicWResp) {
        if (!recv_exact(fidb, 4, false)) break;
        memcpy(&fid, fidb, 4);
        std::vector<Decision> all;
        if (!read_string_decisions(st->fd, second, all)) break;
        ConnState::Entry e;
        bool ok = false;
        {
          std::lock_guard<std::mutex> lk(st->m);
          auto it = st->inflight.find(fid);
          if (it != st->inflight.end() && !it->second.fast &&
              it->second.n == second) {
            e = std::move(it->second);
            st->inflight.erase(it);
            ok = true;
          }
        }
        if (!ok) break;
        st->cv.notify_all();
        fill_string_decisions(e.batch, all);
        for (Shard* s : e.batch) finish_shard(s, RtStatus::kOk);
        continue;
      }
      break;  // unknown magic: desynced
    }
    st->kill();  // unblock a writer mid-send; sends now fail fast
    drain_windowed(st, fail_as);
  }

  // Stream one batch as a windowed frame: register it in the in-flight
  // table (credit-gated), send, and return without waiting — the
  // reader finishes the shards whenever the response lands. Returns
  // false when the connection must be dropped; the batch's shards are
  // finished on every failure path.
  bool send_windowed(const std::shared_ptr<ConnState>& st,
                     std::vector<Shard*>& batch, bool fast,
                     uint32_t& next_frame_id) {
    std::string payload;
    uint32_t n = fast ? build_fast_payload(batch, payload)
                      : build_string_payload(batch, payload);
    uint32_t window = (uint32_t)std::max(1, window_.load());
    uint32_t fid;
    {
      std::unique_lock<std::mutex> lk(st->m);
      // credit gate: at most `window` frames in flight per connection
      // (the bridge advertises the window it is willing to serve
      // concurrently; beyond it frames would only queue in its socket)
      wait_logged(
          st->cv, lk,
          [&] { return st->dead || st->inflight.size() < window; }, "credit",
          [&] {
            return describe() + " inflight=" + std::to_string(st->inflight.size()) +
                   " window=" + std::to_string(window);
          });
      if (st->dead) {
        lk.unlock();
        for (Shard* s : batch) finish_shard(s, RtStatus::kFail);
        return false;
      }
      fid = next_frame_id++;
      auto& e = st->inflight[fid];
      e.batch = batch;
      e.fast = fast;
      e.n = n;
      e.sent = std::chrono::steady_clock::now();
    }
    std::string frame;
    uint64_t t_sent = mono_us();
    if (fast) {
      put_u32(frame, kMagicWFastReq);
      put_u32(frame, n);
      put_u32(frame, fid);
      put_u32(frame, batch[0]->ring_hash);  // batches share one view
      frame.append((const char*)&t_sent, 8);
      put_u32(frame, (uint32_t)payload.size());
    } else {
      put_u32(frame, kMagicWReq);
      put_u32(frame, n);
      put_u32(frame, fid);
      frame.append((const char*)&t_sent, 8);
      put_u32(frame, (uint32_t)payload.size());
    }
    frame += payload;
    if (!send_all(st->fd, frame.data(), frame.size())) {
      // a partial write desyncs the stream: reclaim OUR frame if the
      // reader hasn't already drained it, then drop the connection
      bool mine;
      {
        std::lock_guard<std::mutex> lk(st->m);
        mine = st->inflight.erase(fid) > 0;
      }
      if (mine)
        for (Shard* s : batch) finish_shard(s, RtStatus::kFail);
      return false;
    }
    return true;
  }

  void run() {
    int fd = connect_backend();
    if (fd >= 0) connected_.fetch_add(1);
    std::shared_ptr<ConnState> st;  // non-null = windowed connection
    uint32_t next_frame_id = 1;
    auto adopt_windowed = [&] {
      if (fd >= 0 && windowed_.load()) {
        st = std::make_shared<ConnState>();
        st->fd = fd;
        auto self = shared_from_this();
        auto stc = st;
        std::thread([self, stc] { self->reader_loop(stc); }).detach();
      }
    };
    auto drop_conn = [&] {
      if (st) {
        st->kill();  // reader fails anything left in flight and exits
        st.reset();  // last ConnState owner closes the fd
      } else if (fd >= 0) {
        close(fd);
      }
      if (fd >= 0) connected_.fetch_sub(1);
      fd = -1;
    };
    adopt_windowed();
    started_.fetch_add(1);
    int* where = nullptr;  // the worker-state count this worker is in
    auto set_state = [&](int* to) {
      std::lock_guard<std::mutex> lk(m_);
      if (where) --*where;
      if (to) ++*to;
      where = to;
    };
    while (true) {
      std::vector<Shard*> batch;
      bool fast = false;
      set_state(&n_idle_);
      {
        std::unique_lock<std::mutex> lk(m_);
        cv_.wait(lk, [this] {
          return stopping_ || !queue_.empty() || !fast_queue_.empty();
        });
        if (stopping_) break;
        // batch window: flush at limit_ items or after wait_us_
        if ((int)queued_items_ < limit_ && wait_us_ > 0) {
          cv_.wait_for(lk, std::chrono::microseconds(wait_us_), [this] {
            return stopping_ || (int)queued_items_ >= limit_;
          });
        }
        // one frame kind per round-trip; drain the deeper queue first
        // (both nonempty alternates naturally as they drain)
        fast = fast_queue_.size() >= queue_.size() && !fast_queue_.empty();
        auto& q = fast ? fast_queue_ : queue_;
        size_t take_items = 0;
        while (!q.empty()) {
          Shard* head = q.front();
          size_t next = head->idx.size();
          if (!batch.empty() && (int)(take_items + next) > limit_) break;
          // a fast frame carries ONE ring fingerprint: shards routed
          // under different membership views never co-batch
          if (fast && !batch.empty() &&
              head->ring_hash != batch[0]->ring_hash)
            break;
          batch.push_back(head);
          take_items += next;
          q.pop_front();
          if ((int)take_items >= limit_) break;
        }
        queued_items_ -= take_items;
      }
      if (batch.empty()) continue;
      set_state(&n_busy_);
      if (fd < 0) {
        fd = connect_backend();
        if (fd >= 0) {
          connected_.fetch_add(1);
          adopt_windowed();
        }
      }
      if (fast && fd >= 0 && !fast_ok_.load()) {
        // safety net (the router folds non-fast peers' items into the
        // slow path at routing time): never put a pre-hashed frame on
        // a bridge that didn't advertise it — and don't churn the
        // healthy connection either; nothing was sent
        for (Shard* s : batch) finish_shard(s, RtStatus::kFail);
        continue;
      }
      if (st) {
        // windowed: stream the frame and immediately collect the next
        // batch — the reader completes it whenever the bridge answers
        if (!send_windowed(st, batch, fast, next_frame_id)) drop_conn();
        continue;
      }
      RtStatus rst = RtStatus::kFail;
      if (fd >= 0) {
        rst = fast ? roundtrip_fast(fd, batch) : roundtrip(fd, batch);
        if (rst != RtStatus::kOk) {
          // GEBR also closes bridge-side; reconnecting re-reads the
          // hello, which (on the primary lane) republishes the ring
          close(fd);
          fd = -1;
          connected_.fetch_sub(1);
        }
      }
      for (Shard* s : batch) finish_shard(s, rst);
    }
    set_state(nullptr);
    if (st) {
      // bounded drain: let in-flight windowed frames finish before the
      // kill, preserving shutdown()'s in-flight-completes contract
      std::unique_lock<std::mutex> lk(st->m);
      st->cv.wait_for(lk, std::chrono::seconds(5), [&] {
        return st->inflight.empty() || st->dead;
      });
    }
    drop_conn();
  }

  Endpoint ep_;
  int wait_us_;
  int limit_;
  std::atomic<int> connected_{0};
  std::atomic<int> started_{0};
  std::atomic<bool> fast_ok_{false};
  // windowed capability from the last hello (per-lane; connections made
  // before a bridge upgrade keep their negotiated mode)
  std::atomic<bool> windowed_{false};
  std::atomic<int> window_{0};
  HelloFn on_hello_;
  std::mutex m_;
  std::condition_variable cv_;
  bool stopping_ = false;  // guarded by m_
  std::deque<Shard*> queue_;
  std::deque<Shard*> fast_queue_;
  size_t queued_items_ = 0;
  int n_idle_ = 0;  // workers by state, guarded by m_
  int n_busy_ = 0;
};

class Router {
 public:
  Router(const std::string& primary, int batch_wait_us, int batch_limit,
         int workers, int refresh_ms)
      : primary_ep_(parse_endpoint(primary)),
        wait_us_(batch_wait_us),
        limit_(batch_limit),
        workers_(workers),
        refresh_ms_(refresh_ms) {
    primary_ = Lane::create(
        primary_ep_, wait_us_, limit_, workers_,
        [this](const Ring& r) { publish_ring(r); },
        /*wait_connect=*/true);
  }

  void start_refresher() {
    // ONE long-lived refresher: re-reads the ring every refresh_ms_,
    // or immediately when request_refresh() wakes it (a stale frame
    // was refused). Keeps thread churn off the request path entirely.
    std::thread([this] {
      while (!g_shutdown.load()) {
        {
          std::unique_lock<std::mutex> lk(refresh_cv_m_);
          refresh_cv_.wait_for(
              lk, std::chrono::milliseconds(refresh_ms_),
              [this] { return refresh_asap_; });
          refresh_asap_ = false;
        }
        refresh_ring();
      }
    }).detach();
  }

  bool backend_ok() const { return primary_->backend_ok(); }

  // Split into shards, route, wait. Returns false only when EVERY
  // shard failed (callers answer 503/UNAVAILABLE, matching the
  // single-backend behavior); partial failures become per-item errors,
  // like instance-side peer forwards (serve/instance.py forward()).
  bool execute(Pending& p) {
    if (p.items.empty()) return true;
    p.decisions.assign(p.items.size(), Decision());
    std::shared_ptr<const Ring> ring = current_ring();

    Shard slow;
    slow.parent = &p;
    std::map<int, Shard> fast_by_node;
    // per-owner STRING shards (r7 slow-path owner batching): items
    // that fall off the pre-hashed path (fast kill switch, a peer
    // that doesn't advertise it, mixed fleets) but whose OWNER has a
    // reachable bridge ship as string frames straight to that owner —
    // the owner serves them locally through its full instance —
    // instead of funnelling through the primary's instance and a
    // second gRPC forwarding hop. String frames carry no ring
    // fingerprint: a stale-routed item is simply forwarded by its
    // receiver, so this path needs no GEBR machinery.
    std::map<int, Shard> slow_by_node;
    std::map<int, std::shared_ptr<Lane>> lane_by_node;
    auto lane_at = [&](int node) -> std::shared_ptr<Lane>& {
      auto lit = lane_by_node.find(node);
      if (lit == lane_by_node.end())
        lit = lane_by_node
                  .emplace(node, lane_for(ring->nodes[node].bridge))
                  .first;
      return lit->second;
    };
    for (uint32_t i = 0; i < p.items.size(); ++i) {
      Item& it = p.items[i];
      // GLOBAL needs the instance's replica/gossip path; empty fields
      // need its per-item validation errors — both stay on the
      // primary. Ownership itself only needs the ring (carried by the
      // hello regardless of the fast capability).
      bool routable = ring && it.behavior != 2 && !it.name.empty() &&
                      !it.key.empty();
      int node = -1;
      if (routable) {
        node = ring->owner(it.name, it.key);
        routable = node >= 0;
      }
      bool eligible = routable && ring->fast;
      if (eligible && !ring->nodes[node].self) {
        const Node& nd = ring->nodes[node];
        if (nd.bridge.empty()) {
          eligible = false;
        } else {
          // a departed endpoint (nullptr: this ring snapshot predates
          // an eviction) or a peer that hasn't advertised the fast
          // path (mixed fleet, or its lane hasn't completed the first
          // hello yet) gets its items over the slow path instead of a
          // doomed pre-hashed frame
          auto& lane = lane_at(node);
          if (!lane || !lane->fast_advertised()) eligible = false;
        }
      }
      if (eligible) {
        Shard& sh = fast_by_node[node];
        if (sh.parent == nullptr) {
          sh.parent = &p;
          sh.fast = true;
          sh.ring_hash = ring->hash;
          if (!ring->nodes[node].self)
            sh.owner = ring->nodes[node].grpc;
        }
        sh.idx.push_back(i);
        it.hash = slot_hash(it.name, it.key);
        continue;
      }
      // slow path: per-owner where the owner's bridge is reachable,
      // the primary's string frame otherwise
      if (routable && !ring->nodes[node].self &&
          !ring->nodes[node].bridge.empty() && lane_at(node)) {
        Shard& sh = slow_by_node[node];
        if (sh.parent == nullptr) {
          sh.parent = &p;
          sh.owner = ring->nodes[node].grpc;
        }
        sh.idx.push_back(i);
        continue;
      }
      slow.idx.push_back(i);
    }

    // Degraded-cluster heuristic: when the ONLY fast destination is
    // this node and most items fold to the string path anyway (peers
    // without reachable bridges — e.g. a cluster without
    // GUBER_EDGE_TCP), splitting buys one small array frame at the
    // cost of a second backend round-trip per request; measured on the
    // 6-node no-bridge topology that trade LOSES (~15% door
    // throughput), so fold the minority self-fast items into the slow
    // frame and send ONE frame, the pre-r5 shape. Single-node (slow
    // minority) and real clusters (remote fast shards exist) keep the
    // split.
    if (fast_by_node.size() == 1 && !slow.idx.empty()) {
      auto it = fast_by_node.begin();
      if (ring->nodes[it->first].self &&
          it->second.idx.size() < slow.idx.size()) {
        for (uint32_t i : it->second.idx) slow.idx.push_back(i);
        std::sort(slow.idx.begin(), slow.idx.end());
        fast_by_node.clear();
      }
    }

    int n_shards = (slow.idx.empty() ? 0 : 1) +
                   (int)slow_by_node.size() + (int)fast_by_node.size();
    {
      std::lock_guard<std::mutex> lk(p.m);
      p.shards_left = n_shards;
    }
    if (!slow.idx.empty() && !primary_->submit(&slow))
      finish_shard(&slow, RtStatus::kFail);
    for (auto& [node, sh] : slow_by_node) {
      if (!lane_by_node.at(node)->submit(&sh))
        finish_shard(&sh, RtStatus::kFail);
    }
    for (auto& [node, sh] : fast_by_node) {
      std::shared_ptr<Lane> lane = ring->nodes[node].self
                                       ? primary_
                                       : lane_by_node.at(node);
      if (!lane->submit(&sh)) finish_shard(&sh, RtStatus::kFail);
    }
    {
      std::unique_lock<std::mutex> lk(p.m);
      wait_logged(
          p.cv, lk, [&p] { return p.shards_left == 0; }, "shards", [&] {
            std::string why = std::to_string(p.shards_left) + " of " +
                              std::to_string(n_shards) + " shards open; " +
                              primary_->describe();
            for (auto& [node, lane] : lane_by_node)
              if (lane) why += "; " + lane->describe();
            return why;
          });
    }

    bool any_ok = false, saw_stale = false;
    auto fill_errors = [&](const Shard& s, const std::string& why) {
      for (uint32_t i : s.idx) {
        Decision& d = p.decisions[i];
        d = Decision();
        d.error = "while fetching rate limit '" + p.items[i].name + "_" +
                  p.items[i].key + "' from peer - '" + why + "'";
      }
    };
    // string shards can fail kStale too (r7): a GEBR refusing a fast
    // frame drains EVERY frame in flight on that connection as stale,
    // string frames included — those must surface as the per-item
    // retry error and wake the refresher, not read as a dead backend
    if (!slow.idx.empty()) {
      if (slow.failed) {
        saw_stale |= slow.stale;
        fill_errors(slow, slow.stale
                              ? "edge: cluster membership changed; retry"
                              : "edge backend unavailable");
      } else {
        any_ok = true;
      }
    }
    for (auto& [node, sh] : slow_by_node) {
      (void)node;
      if (!sh.failed) {
        any_ok = true;
        continue;
      }
      saw_stale |= sh.stale;
      fill_errors(sh, sh.stale
                          ? "edge: cluster membership changed; retry"
                          : "edge: bridge " + sh.owner + " unreachable");
    }
    for (auto& [node, sh] : fast_by_node) {
      (void)node;
      if (!sh.failed) {
        any_ok = true;
        continue;
      }
      saw_stale |= sh.stale;
      fill_errors(sh, sh.stale
                          ? "edge: cluster membership changed; retry"
                          : "edge: bridge " +
                                (sh.owner.empty() ? primary_ep_.spec
                                                  : sh.owner) +
                                " unreachable");
    }
    if (saw_stale) {
      // refresh OFF the request path: connect_endpoint + hello can
      // block up to ~10s against a wedged primary, and the per-item
      // "membership changed; retry" errors are already composed — the
      // reply must not wait on the re-read. Waking the long-lived
      // refresher costs a notify, not a thread.
      {
        std::lock_guard<std::mutex> lk(refresh_cv_m_);
        refresh_asap_ = true;
      }
      refresh_cv_.notify_one();
    }
    // a stale ring is a transient routing miss, not a dead backend:
    // surface the per-item retry errors as a normal response instead
    // of a blanket 503
    return any_ok || saw_stale;
  }

 private:
  std::shared_ptr<const Ring> current_ring() {
    std::lock_guard<std::mutex> lk(ring_m_);
    return ring_;
  }

  void publish_ring(const Ring& r) {
    auto next = std::make_shared<Ring>(r);
    {
      std::lock_guard<std::mutex> lk(ring_m_);
      ring_ = next;
    }
    // Evict lanes whose endpoint left the membership: under pod-IP
    // discovery (k8s rollouts) endpoints are never reused, so an
    // unevicted lane strands its worker threads forever. In-flight
    // round-trips finish; queued shards fail; the Lane frees itself
    // when its last detached worker exits.
    std::vector<std::shared_ptr<Lane>> evicted;
    {
      std::lock_guard<std::mutex> lk(lanes_m_);
      for (auto it = lanes_.begin(); it != lanes_.end();) {
        bool live = false;
        for (const Node& nd : next->nodes)
          if (!nd.self && nd.bridge == it->first) live = true;
        if (live) {
          ++it;
        } else {
          evicted.push_back(it->second);
          it = lanes_.erase(it);
        }
      }
    }
    for (auto& lane : evicted) lane->shutdown();
    // pre-warm lanes for every peer bridge in the new membership so
    // the first request after a ring change doesn't ride the slow
    // path while the lane's first hello is still in flight
    for (const Node& nd : next->nodes)
      if (!nd.self && !nd.bridge.empty()) lane_for(nd.bridge);
  }

  // one short-lived hello round-trip to the primary bridge, debounced:
  // concurrent stale shards must not stampede the bridge with connects
  void refresh_ring() {
    auto now = std::chrono::steady_clock::now();
    {
      std::lock_guard<std::mutex> lk(refresh_m_);
      if (now - last_refresh_ < std::chrono::milliseconds(50)) return;
      last_refresh_ = now;
    }
    int fd = connect_endpoint(primary_ep_);
    if (fd < 0) return;
    timeval tv{};
    tv.tv_sec = 5;
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
    Ring r;
    if (read_hello(fd, &r)) publish_ring(r);
    close(fd);
  }

  // get-or-create the lane for a peer bridge endpoint; publish_ring
  // evicts lanes for departed endpoints. The returned shared_ptr keeps
  // a lane usable by an in-flight execute() even if eviction races it
  // (submit on a stopped lane fails cleanly instead of dangling).
  // Returns nullptr for an endpoint NOT in the CURRENT ring: an
  // in-flight execute() routing with a pre-eviction ring must not
  // resurrect a just-evicted lane — the recreated lane's detached
  // workers would sit on a dead peer until the next ring publish
  // (ADVICE r5 #1); the caller folds those items into the slow path.
  std::shared_ptr<Lane> lane_for(const std::string& spec) {
    // ring before lanes_m_ — current_ring() takes ring_m_, and
    // publish_ring never holds ring_m_ while taking lanes_m_
    std::shared_ptr<const Ring> ring = current_ring();
    std::lock_guard<std::mutex> lk(lanes_m_);
    auto it = lanes_.find(spec);
    if (it != lanes_.end()) return it->second;
    bool member = false;
    if (ring)
      for (const Node& nd : ring->nodes)
        if (!nd.self && nd.bridge == spec) member = true;
    if (!member) return nullptr;
    auto lane =
        Lane::create(parse_endpoint(spec), wait_us_, limit_, workers_,
                     nullptr, /*wait_connect=*/false);
    lanes_.emplace(spec, lane);
    return lane;
  }

  Endpoint primary_ep_;
  std::shared_ptr<Lane> primary_;
  int wait_us_;
  int limit_;
  int workers_;
  int refresh_ms_;
  std::mutex ring_m_;
  std::shared_ptr<const Ring> ring_;
  std::mutex lanes_m_;
  std::unordered_map<std::string, std::shared_ptr<Lane>> lanes_;
  std::mutex refresh_m_;
  std::chrono::steady_clock::time_point last_refresh_{};
  std::mutex refresh_cv_m_;
  std::condition_variable refresh_cv_;
  bool refresh_asap_ = false;  // guarded by refresh_cv_m_
};

// -------------------------------------------------------------- HTTP layer

// Returns false when the reply could not be fully written (e.g. the
// client stopped reading and SO_SNDTIMEO expired) — the caller must
// close the connection rather than let a non-reading client pin the
// thread or desync the stream.
bool http_reply(int fd, int code, const char* reason,
                const std::string& body) {
  char hdr[256];
  int n = snprintf(hdr, sizeof hdr,
                   "HTTP/1.1 %d %s\r\n"
                   "Content-Type: application/json\r\n"
                   "Content-Length: %zu\r\n\r\n",
                   code, reason, body.size());
  std::string out;
  out.reserve((size_t)n + body.size());
  out.append(hdr, (size_t)n);
  out.append(body);
  size_t off = 0;
  while (off < out.size()) {
    ssize_t w = call_logged("http write", fd, [&] {
      return write(fd, out.data() + off, out.size() - off);
    });
    if (w <= 0) return false;
    off += (size_t)w;
  }
  return true;
}

// Thread-per-connection needs bounds or a slow-loris client pins OS
// threads forever: every accepted socket gets a receive timeout (read()
// returns EAGAIN and the connection closes) and the total connection
// count is capped (excess accepts are answered 503 and closed).
std::atomic<int> g_conns{0};
int g_max_conns = 4096;
int g_recv_timeout_s = 60;

struct ConnGuard {
  ~ConnGuard() { g_conns.fetch_sub(1, std::memory_order_relaxed); }
};

void serve_connection(int fd, Router* router) {
  ConnGuard guard;
  std::string buf;
  char tmp[16384];
  while (true) {
    // Per-request wall deadline: SO_RCVTIMEO alone only bounds a single
    // idle read — a client trickling one byte per interval would renew
    // it forever. A whole request (headers + body) must complete within
    // the budget or the connection closes.
    const auto req_deadline = std::chrono::steady_clock::now() +
                              std::chrono::seconds(g_recv_timeout_s);
    auto expired = [&] {
      return std::chrono::steady_clock::now() > req_deadline;
    };
    // read until end of headers
    size_t hdr_end;
    while ((hdr_end = buf.find("\r\n\r\n")) == std::string::npos) {
      // nothing of the next request yet: an idle keep-alive peer
      ssize_t r = buf.empty()
                      ? read(fd, tmp, sizeof tmp)
                      : call_logged("http read", fd, [&] { return read(fd, tmp, sizeof tmp); });
      if (r <= 0 || expired()) {
        close(fd);
        return;
      }
      buf.append(tmp, (size_t)r);
      if (buf.size() > (16u << 20)) { close(fd); return; }
    }
    std::string head = buf.substr(0, hdr_end);
    bool has_clen = false;
    size_t content_len = 0;
    {
      // case-insensitive content-length scan
      std::string lower = head;
      for (char& c : lower) c = (char)tolower(c);
      size_t pos = lower.find("content-length:");
      if (pos != std::string::npos) {
        has_clen = true;
        content_len = strtoull(lower.c_str() + pos + 15, nullptr, 10);
      }
    }
    bool is_post = head.rfind("POST", 0) == 0;
    if (is_post && !has_clen) {
      // no chunked support: fail clean and close (a desynced keep-alive
      // stream would mis-parse the chunk body as the next request)
      http_reply(fd, 411, "Length Required",
                 "{\"error\": \"Content-Length required\"}");
      close(fd);
      return;
    }
    if (content_len > (16u << 20)) {
      http_reply(fd, 413, "Payload Too Large",
                 "{\"error\": \"body exceeds 16 MiB\"}");
      close(fd);
      return;
    }
    size_t body_start = hdr_end + 4;
    while (buf.size() < body_start + content_len) {
      ssize_t r = call_logged("http read", fd, [&] { return read(fd, tmp, sizeof tmp); });
      if (r <= 0 || expired()) { close(fd); return; }
      buf.append(tmp, (size_t)r);
    }

    bool is_post_grl = head.rfind("POST /v1/GetRateLimits", 0) == 0;
    bool is_health = head.rfind("GET /v1/HealthCheck", 0) == 0;
    bool sent;
    if (is_health) {
      sent = http_reply(fd, 200, "OK",
                        router->backend_ok()
                            ? "{\"status\": \"healthy\", \"message\": "
                              "\"edge\", \"peerCount\": 0}"
                            : "{\"status\": \"unhealthy\", \"message\": "
                              "\"backend unreachable\", \"peerCount\": 0}");
    } else if (!is_post_grl) {
      sent = http_reply(fd, 404, "Not Found", "{\"error\": \"not found\"}");
    } else {
      Pending p;
      if (!parse_get_rate_limits(buf.data() + body_start, content_len,
                                 p.items)) {
        sent = http_reply(fd, 400, "Bad Request",
                          "{\"error\": \"malformed JSON\"}");
      } else if ([&] {
                   for (const Item& it : p.items)
                     if (it.name.size() > 65535 || it.key.size() > 65535)
                       return true;
                   return false;
                 }()) {
        sent = http_reply(fd, 400, "Bad Request",
                          "{\"error\": \"name/unique_key exceeds 65535 "
                          "bytes\"}");
      } else if (p.items.empty()) {
        sent = http_reply(fd, 200, "OK", "{\"responses\": []}");
      } else {
        if (!router->execute(p)) {
          sent = http_reply(fd, 503, "Service Unavailable",
                            "{\"error\": \"backend unavailable\"}");
        } else {
          sent = http_reply(fd, 200, "OK",
                            render_responses(p.decisions.data(),
                                             p.decisions.size()));
        }
      }
    }
    if (!sent) {  // client stopped reading (SO_SNDTIMEO expired)
      close(fd);
      return;
    }
    buf.erase(0, body_start + content_len);
  }
}

// gRPC/HTTP2 terminator (serve_grpc_connection + HPACK + proto codec);
// shares Item/Decision/Router above, hence the in-namespace include
#include "h2_grpc.inc"

}  // namespace

static const char kUsage[] =
    "guber-edge: native HTTP/JSON + gRPC front door for gubernator-tpu\n"
    "  --listen PORT          TCP port to serve HTTP on (default 8080)\n"
    "  --grpc-listen PORT     TCP port to serve gRPC (h2c) on "
    "(default 0 = off)\n"
    "  --backend PATH         daemon's edge unix socket "
    "(default /tmp/guber-edge.sock)\n"
    "  --batch-wait-us N      cross-connection batch window (default 500)\n"
    "  --ring-refresh-ms N    cluster ring re-read period (default 1000)\n"
    "  --peer-timeout-s N     peer-bridge round-trip deadline "
    "(default 30)\n"
    "  --batch-limit N        max requests per backend frame (default 1000)\n"
    "  --workers N            pipelined backend connections (default 2)\n"
    "  --max-conns N          client connection cap (default 4096)\n"
    "  --recv-timeout-s N     per-read client timeout (default 60)\n";

// Strict non-negative integer parse: a typo'd VALUE ("80O0", "abc")
// must fail loudly, not atoi-truncate into serving the wrong port.
static bool parse_int_flag(const char* v, int* out) {
  char* end = nullptr;
  long x = strtol(v, &end, 10);
  if (end == v || *end != '\0' || x < 0 || x > (1L << 30)) return false;
  *out = static_cast<int>(x);
  return true;
}

int main(int argc, char** argv) {
  // a client that resets its connection mid-write must fail that write
  // (EPIPE), not SIGPIPE-kill the whole edge — e.g. the GOAWAY sent
  // while tearing down an h2 connection the peer already closed
  signal(SIGPIPE, SIG_IGN);
  if (pipe(g_wake_pipe) != 0) {
    perror("pipe");
    return 1;
  }
  // SA_RESTART kept: in-flight reads/writes on connection and batcher
  // threads must not be aborted by the shutdown signal; the self-pipe
  // wakes the accept loops regardless of which thread took delivery
  struct sigaction sa{};
  sa.sa_handler = on_term;
  sa.sa_flags = SA_RESTART;
  sigaction(SIGTERM, &sa, nullptr);
  sigaction(SIGINT, &sa, nullptr);
  int port = 8080;
  int grpc_port = 0;
  std::string backend = "/tmp/guber-edge.sock";
  int batch_wait_us = 500;
  int batch_limit = 1000;
  int workers = 2;
  int ring_refresh_ms = 1000;
  for (int i = 1; i < argc; i += 2) {
    std::string a = argv[i];
    if (a == "--help" || a == "-h") {
      fputs(kUsage, stdout);
      return 0;
    }
    if (i + 1 >= argc) {
      fprintf(stderr, "missing value for %s\n%s", a.c_str(), kUsage);
      return 2;
    }
    const char* v = argv[i + 1];
    bool ok = true;
    if (a == "--listen") ok = parse_int_flag(v, &port);
    else if (a == "--grpc-listen") ok = parse_int_flag(v, &grpc_port);
    else if (a == "--backend") backend = v;
    else if (a == "--batch-wait-us") ok = parse_int_flag(v, &batch_wait_us);
    else if (a == "--ring-refresh-ms") {
      ok = parse_int_flag(v, &ring_refresh_ms);
      ring_refresh_ms = std::max(50, ring_refresh_ms);
    }
    else if (a == "--peer-timeout-s") {
      ok = parse_int_flag(v, &g_peer_timeout_s);
      g_peer_timeout_s = std::max(1, g_peer_timeout_s);
    }
    else if (a == "--batch-limit") ok = parse_int_flag(v, &batch_limit);
    else if (a == "--workers") {
      ok = parse_int_flag(v, &workers);
      workers = std::max(1, workers);
    } else if (a == "--max-conns") {
      ok = parse_int_flag(v, &g_max_conns);
      g_max_conns = std::max(1, g_max_conns);
    } else if (a == "--recv-timeout-s") {
      ok = parse_int_flag(v, &g_recv_timeout_s);
      g_recv_timeout_s = std::max(1, g_recv_timeout_s);
    } else {
      // a typo'd flag silently ignored would serve with defaults — fail
      fprintf(stderr, "unknown flag %s\n%s", a.c_str(), kUsage);
      return 2;
    }
    if (!ok) {
      fprintf(stderr, "bad value for %s: %s\n%s", a.c_str(), v, kUsage);
      return 2;
    }
  }

  // the frame protocol splits host:port on the LAST colon, so an IPv6
  // --backend ('[::1]:9100', bare '::1') would misparse silently
  // (bracketed host handed to the resolver, or the address mistaken
  // for a unix path). Refuse at config parse time (ADVICE r5 #2).
  if (endpoint_is_ipv6ish(backend)) {
    fprintf(stderr,
            "--backend '%s' looks like an IPv6 literal; the backend must "
            "be a unix socket path or an IPv4/hostname 'host:port'\n",
            backend.c_str());
    return 2;
  }

  // bind BEFORE constructing the router: its primary lane blocks on
  // eager worker connects, and a bind failure should exit before
  // spawning any detached lane threads
  int srv = socket(AF_INET, SOCK_STREAM, 0);
  if (srv < 0) {
    perror("socket");
    return 1;
  }
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (bind(srv, (sockaddr*)&addr, sizeof addr) != 0 || listen(srv, 512) != 0) {
    perror("bind/listen");
    return 1;
  }

  // gRPC listener binds up front too (fail fast on a taken port)
  int grpc_srv = -1;
  if (grpc_port > 0) {
    grpc_srv = socket(AF_INET, SOCK_STREAM, 0);
    if (grpc_srv < 0) {
      perror("socket");
      return 1;
    }
    setsockopt(grpc_srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in gaddr{};
    gaddr.sin_family = AF_INET;
    gaddr.sin_addr.s_addr = htonl(INADDR_ANY);
    gaddr.sin_port = htons((uint16_t)grpc_port);
    if (bind(grpc_srv, (sockaddr*)&gaddr, sizeof gaddr) != 0 ||
        listen(grpc_srv, 512) != 0) {
      perror("bind/listen (grpc)");
      return 1;
    }
  }

  Router router(backend, batch_wait_us, batch_limit, workers,
                ring_refresh_ms);
  router.start_refresher();
  fprintf(stderr, "guber-edge listening on :%d%s backend=%s\n", port,
          grpc_port > 0
              ? (" grpc=:" + std::to_string(grpc_port)).c_str()
              : "",
          backend.c_str());
  fflush(stderr);

  auto accept_loop = [&one](int lsrv, Router* b, bool grpc) {
    pollfd pfds[2] = {{lsrv, POLLIN, 0}, {g_wake_pipe[0], POLLIN, 0}};
    while (!g_shutdown.load()) {
      pfds[0].revents = pfds[1].revents = 0;
      if (poll(pfds, 2, -1) < 0) continue;  // EINTR etc: re-check flag
      if (g_shutdown.load() || (pfds[1].revents & POLLIN)) break;
      if (!(pfds[0].revents & POLLIN)) continue;
      int fd = call_logged(grpc ? "grpc accept" : "http accept", lsrv,
                           [&] { return accept(lsrv, nullptr, nullptr); });
      if (fd < 0) continue;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
      // receive timeout: a slow-loris / idle keep-alive client gets its
      // read() failed after --recv-timeout-s and the thread exits. The
      // same timeout bounds gRPC connections (gRPC clients keep
      // connections alive with PINGs well inside any sane timeout).
      timeval tv{};
      tv.tv_sec = g_recv_timeout_s;
      setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
      // send timeout: a client that stops reading its response must
      // fail the write, not block the thread forever
      setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
      if (g_conns.fetch_add(1, std::memory_order_relaxed) >= g_max_conns) {
        g_conns.fetch_sub(1, std::memory_order_relaxed);
        if (!grpc)
          http_reply(fd, 503, "Service Unavailable",
                     "{\"error\": \"connection limit reached\"}");
        close(fd);  // gRPC: plain close; client sees connection refused
        continue;
      }
      std::thread(grpc ? serve_grpc_connection : serve_connection, fd, b)
          .detach();
    }
  };

  if (grpc_srv >= 0) {
    std::thread(accept_loop, grpc_srv, &router, true).detach();
  }
  accept_loop(srv, &router, false);

  // graceful drain: stop taking connections, give in-flight requests a
  // bounded window to finish, then exit 0. Connection threads are
  // detached; g_conns counts the live ones.
  close(srv);
  if (grpc_srv >= 0) close(grpc_srv);
  fprintf(stderr, "guber-edge: shutdown signal; draining %d conns\n",
          g_conns.load());
  fflush(stderr);
  const auto deadline =
      std::chrono::steady_clock::now() + std::chrono::seconds(10);
  while (g_conns.load() > 0 &&
         std::chrono::steady_clock::now() < deadline) {
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
  fprintf(stderr, "guber-edge: exiting (%d conns remained)\n",
          g_conns.load());
  fflush(nullptr);
  // _exit: detached lane workers and the refresher still reference the
  // stack Router; running destructors under them would be a
  // use-after-free. After the drain there is nothing left worth
  // running destructors for.
  _exit(0);
}
