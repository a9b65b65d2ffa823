// tsio — native IO runtime for the TPU ATSC framework.
//
// The TPU-native analog of the reference's C++ CLI IO layer
// (reference util/atsc_encoder.cpp:83-101: blocking fread of field-sized
// chunks + writeStream with real-time back-pressure). Here both sides run
// on background threads with ring buffers so the Python driver never
// blocks on IO between device steps:
//
//   * ts_reader: file/stdin -> ring buffer, with TS sync-byte alignment
//     (drop bytes until buf[k*188] == 0x47 holds for a run of packets).
//     Also accepts "udp://[group]:port" — the standard headend feed
//     (UDP/RTP multicast TS per SMPTE 2022-2, i.e. what ffmpeg's
//     `-f mpegts udp://...` emits); RTP headers are auto-stripped.
//   * iq_sink: ring buffer -> null/file sink, optionally paced to the
//     8VSB sample clock (the SDR's role as pacemaker in the reference).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread tsio.cpp -o libtsio.so
// Exposed via ctypes (see io.py); plain C ABI.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

namespace {

constexpr size_t TS_PACKET = 188;

struct Ring {
    std::vector<uint8_t> buf;
    std::atomic<size_t> head{0};  // producer writes at head
    std::atomic<size_t> tail{0};  // consumer reads at tail
    explicit Ring(size_t n) : buf(n) {}
    size_t size() const { return buf.size(); }
    size_t readable() const { return head.load() - tail.load(); }
    size_t writable() const { return size() - readable(); }
    void write(const uint8_t* src, size_t n) {  // caller checked writable
        size_t h = head.load();
        size_t off = h % size();
        size_t first = std::min(n, size() - off);
        memcpy(buf.data() + off, src, first);
        memcpy(buf.data(), src + first, n - first);
        head.store(h + n);
    }
    void read(uint8_t* dst, size_t n) {  // caller checked readable
        size_t t = tail.load();
        size_t off = t % size();
        size_t first = std::min(n, size() - off);
        memcpy(dst, buf.data() + off, first);
        memcpy(dst + first, buf.data(), n - first);
        tail.store(t + n);
    }
};

// If the datagram is RTP-wrapped TS (RFC 3550 / SMPTE 2022-2: version-2
// header, 0x47-aligned n*188 payload right after the 12+4*CC fixed header),
// return the header length to strip; else 0 (raw UDP TS or unknown payload).
static size_t rtp_header_len(const uint8_t* d, size_t n) {
    if (n < 13 || (d[0] >> 6) != 2) return 0;
    size_t hdr = 12 + 4 * (d[0] & 0x0f);
    if (n > hdr && d[hdr] == 0x47 && (n - hdr) % TS_PACKET == 0) return hdr;
    return 0;
}

// "host:port" / ":port" / "port" -> bound datagram socket (joining the
// group when host is an IPv4 multicast address), or -1.
static int open_udp(const char* spec) {
    std::string s(spec);
    std::string host;
    std::string port = s;
    auto c = s.rfind(':');
    if (c != std::string::npos) {
        host = s.substr(0, c);
        port = s.substr(c + 1);
    }
    int p = atoi(port.c_str());
    if (p <= 0 || p > 65535) return -1;
    in_addr ha{};
    bool have_host = !host.empty();
    if (have_host && !inet_aton(host.c_str(), &ha)) return -1;
    bool mcast = have_host && (ntohl(ha.s_addr) >> 28) == 0xe;

    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) return -1;
    int one = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    int rcv = 8 << 20;  // ~3.4 s of 19.39 Mbps TS of kernel-side slack
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcv, sizeof(rcv));
    timeval tv{0, 200000};  // recv timeout: the reader polls its stop flag
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)p);
    addr.sin_addr.s_addr =
        (have_host && !mcast) ? ha.s_addr : htonl(INADDR_ANY);
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
        close(fd);
        return -1;
    }
    if (mcast) {
        ip_mreq req{};
        req.imr_multiaddr = ha;
        req.imr_interface.s_addr = htonl(INADDR_ANY);
        if (setsockopt(fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &req,
                       sizeof(req)) < 0) {
            close(fd);
            return -1;
        }
    }
    return fd;
}

struct TsReader {
    FILE* fp = nullptr;
    bool own_fp = false;
    int sock = -1;
    Ring ring;
    std::thread thr;
    std::atomic<bool> stop{false};
    std::atomic<bool> eof{false};
    std::atomic<uint64_t> bytes_in{0};
    std::atomic<uint64_t> resyncs{0};

    explicit TsReader(size_t ring_bytes) : ring(ring_bytes) {}

    // Push chunk[off, off+n) into the ring (blocking on back-pressure).
    bool push(const uint8_t* src, size_t n) {
        while (n > 0) {
            size_t w = ring.writable();
            if (w == 0) {
                if (stop.load()) return false;
                std::this_thread::sleep_for(std::chrono::microseconds(200));
                continue;
            }
            size_t now = std::min(w, n);
            ring.write(src, now);
            src += now;
            n -= now;
        }
        return true;
    }

    void run() {
        std::vector<uint8_t> chunk(1 << 16);
        size_t pend = 0;
        bool synced = false;
        while (!stop.load()) {
            size_t n = fread(chunk.data() + pend, 1, chunk.size() - pend, fp);
            if (n == 0) {
                // EOF with sync never found (short or non-TS input): pass
                // the pending bytes through raw — the reference freads
                // blindly with no alignment at all (util/atsc_encoder.cpp:83)
                if (!synced && pend > 0) push(chunk.data(), pend);
                eof.store(true);
                break;
            }
            bytes_in += n;
            size_t have = pend + n;
            size_t off = 0;
            if (!synced) {
                // find o with chunk[o + k*188] == 0x47 for 4 packets
                for (size_t o = 0; o + 4 * TS_PACKET <= have; o++) {
                    bool ok = true;
                    for (int k = 0; k < 4; k++)
                        if (chunk[o + k * TS_PACKET] != 0x47) { ok = false; break; }
                    if (ok) { off = o; synced = true; break; }
                }
                if (!synced) {
                    if (have == chunk.size()) {
                        // no sync run anywhere in a full 64 KiB window:
                        // raw-aligned passthrough from here on (reference
                        // behavior); only streams that DO carry sync bytes
                        // get leading-junk alignment.
                        synced = true;
                    } else {  // keep everything, retry with more data
                        pend = have;
                        continue;
                    }
                }
                if (off) resyncs++;
            }
            if (!push(chunk.data() + off, have - off)) return;
            pend = 0;
        }
        eof.store(true);
    }

    // Datagram loop: UDP preserves message boundaries, so alignment comes
    // for free per datagram (senders emit n*188 payloads); RTP wrapping is
    // detected and stripped per packet. A live feed has no EOF — the loop
    // ends only on close().
    void run_udp() {
        std::vector<uint8_t> dgram(65536);
        while (!stop.load()) {
            ssize_t n = recv(sock, dgram.data(), dgram.size(), 0);
            if (n <= 0) continue;  // timeout/EINTR: re-check the stop flag
            size_t off = rtp_header_len(dgram.data(), (size_t)n);
            bytes_in += (uint64_t)n;
            if (!push(dgram.data() + off, (size_t)n - off)) return;
        }
        eof.store(true);
    }
};

struct IqSink {
    FILE* fp = nullptr;      // nullptr => null sink
    Ring ring;
    std::thread thr;
    std::atomic<bool> stop{false};
    std::atomic<uint64_t> bytes_out{0};
    double pace_bytes_per_sec = 0.0;  // 0 => unpaced

    explicit IqSink(size_t ring_bytes) : ring(ring_bytes) {}

    void run() {
        std::vector<uint8_t> chunk(1 << 18);
        auto t0 = std::chrono::steady_clock::now();
        uint64_t paced = 0;
        while (true) {
            size_t r = ring.readable();
            if (r == 0) {
                if (stop.load()) break;
                std::this_thread::sleep_for(std::chrono::microseconds(200));
                continue;
            }
            size_t n = std::min(r, chunk.size());
            ring.read(chunk.data(), n);
            if (fp) fwrite(chunk.data(), 1, n, fp);
            bytes_out += n;
            if (pace_bytes_per_sec > 0) {
                paced += n;
                double target_s = (double)paced / pace_bytes_per_sec;
                auto target = t0 + std::chrono::duration_cast<
                    std::chrono::steady_clock::duration>(
                        std::chrono::duration<double>(target_s));
                std::this_thread::sleep_until(target);
            }
        }
        if (fp) fflush(fp);
    }
};

}  // namespace

extern "C" {

void* ts_reader_open(const char* path, size_t ring_bytes) {
    auto* r = new TsReader(ring_bytes ? ring_bytes : (8u << 20));
    if (strncmp(path, "udp://", 6) == 0) {
        r->sock = open_udp(path + 6);
        if (r->sock < 0) {
            delete r;
            return nullptr;
        }
        r->thr = std::thread([r] { r->run_udp(); });
        return r;
    }
    if (strcmp(path, "-") == 0) {
        r->fp = stdin;
    } else {
        r->fp = fopen(path, "rb");
        r->own_fp = true;
    }
    if (!r->fp) { delete r; return nullptr; }
    r->thr = std::thread([r] { r->run(); });
    return r;
}

// Returns bytes copied (<= n). 0 means EOF-and-drained.
size_t ts_reader_read(void* h, uint8_t* dst, size_t n, int blocking) {
    auto* r = static_cast<TsReader*>(h);
    for (;;) {
        size_t avail = r->ring.readable();
        if (avail >= n || (r->eof.load() && avail > 0)) {
            size_t take = std::min(avail, n);
            r->ring.read(dst, take);
            return take;
        }
        if (r->eof.load()) return 0;
        if (!blocking) return 0;
        std::this_thread::sleep_for(std::chrono::microseconds(200));
    }
}

int ts_reader_eof(void* h) {
    auto* r = static_cast<TsReader*>(h);
    return (r->eof.load() && r->ring.readable() == 0) ? 1 : 0;
}

uint64_t ts_reader_bytes(void* h) {
    return static_cast<TsReader*>(h)->bytes_in.load();
}

void ts_reader_close(void* h) {
    auto* r = static_cast<TsReader*>(h);
    r->stop.store(true);
    if (r->thr.joinable()) r->thr.join();
    if (r->own_fp && r->fp) fclose(r->fp);
    if (r->sock >= 0) close(r->sock);
    delete r;
}

void* iq_sink_open(const char* path, size_t ring_bytes, double pace_bytes_per_sec) {
    auto* s = new IqSink(ring_bytes ? ring_bytes : (64u << 20));
    if (strcmp(path, "null") != 0) {
        s->fp = (strcmp(path, "-") == 0) ? stdout : fopen(path, "wb");
        if (!s->fp) { delete s; return nullptr; }
    }
    s->pace_bytes_per_sec = pace_bytes_per_sec;
    s->thr = std::thread([s] { s->run(); });
    return s;
}

// Blocking write with back-pressure (the sink's pace throttles the caller,
// exactly like the SDR writeStream loop in the reference).
void iq_sink_write(void* h, const uint8_t* src, size_t n) {
    auto* s = static_cast<IqSink*>(h);
    while (n > 0) {
        size_t w = s->ring.writable();
        if (w == 0) {
            std::this_thread::sleep_for(std::chrono::microseconds(200));
            continue;
        }
        size_t now = std::min(w, n);
        s->ring.write(src, now);
        src += now;
        n -= now;
    }
}

// Planar (batch, 2, stride) component array -> interleaved (batch,
// n_valid, 2) wire bytes into the ring, so the Python driver hands the
// device's planar output straight down without a numpy transpose pass
// (GIL released for the whole interleave; elem = component bytes:
// 4 = CF32, 2 = CS16, 1 = CS8). Pair packing via wider little-endian
// stores (x86/LE only, like the rest of the wire contract).
static void interleave_pairs(const uint8_t* ip, const uint8_t* qp,
                             uint8_t* dst, size_t n, size_t elem) {
    switch (elem) {
        case 4: {
            auto* a = reinterpret_cast<const uint32_t*>(ip);
            auto* b = reinterpret_cast<const uint32_t*>(qp);
            auto* d = reinterpret_cast<uint64_t*>(dst);
            for (size_t i = 0; i < n; i++)
                d[i] = (uint64_t)a[i] | ((uint64_t)b[i] << 32);
            break;
        }
        case 2: {
            auto* a = reinterpret_cast<const uint16_t*>(ip);
            auto* b = reinterpret_cast<const uint16_t*>(qp);
            auto* d = reinterpret_cast<uint32_t*>(dst);
            for (size_t i = 0; i < n; i++)
                d[i] = (uint32_t)a[i] | ((uint32_t)b[i] << 16);
            break;
        }
        default: {
            auto* d = reinterpret_cast<uint16_t*>(dst);
            for (size_t i = 0; i < n; i++)
                d[i] = (uint16_t)ip[i] | ((uint16_t)qp[i] << 8);
            break;
        }
    }
}

void iq_sink_write_planar(void* h, const uint8_t* src, size_t elem,
                          size_t batch, size_t stride, size_t n_valid) {
    thread_local std::vector<uint8_t> scratch;
    scratch.resize(n_valid * 2 * elem);
    for (size_t b = 0; b < batch; b++) {
        const uint8_t* ip = src + (2 * b) * stride * elem;
        const uint8_t* qp = src + (2 * b + 1) * stride * elem;
        interleave_pairs(ip, qp, scratch.data(), n_valid, elem);
        iq_sink_write(h, scratch.data(), scratch.size());
    }
}

uint64_t iq_sink_bytes(void* h) {
    return static_cast<IqSink*>(h)->bytes_out.load();
}

// Replay k steps of the float32 phasor recurrence z <- z * s from z = 1
// (the per-field oscillator advance, tables/oscillator.py — the quirky
// float32 rounding is the numeric contract, so there is no closed form;
// this is the O(ms)-at-k=1e6 path where a Python scalar loop costs
// seconds). Must be compiled WITHOUT fp contraction (-ffp-contract=off:
// an FMA would round differently from numpy's complex64 multiply); the
// Python loader cross-checks native == numpy at import-use time.
void phasor_replay(float sr, float si, uint64_t k, float* out) {
    float zr = 1.0f, zi = 0.0f;
    for (uint64_t i = 0; i < k; i++) {
        float nr = zr * sr - zi * si;
        float ni = zr * si + zi * sr;
        zr = nr;
        zi = ni;
    }
    out[0] = zr;
    out[1] = zi;
}

void iq_sink_close(void* h) {
    auto* s = static_cast<IqSink*>(h);
    s->stop.store(true);
    if (s->thr.joinable()) s->thr.join();
    if (s->fp && s->fp != stdout) fclose(s->fp);
    delete s;
}

}  // extern "C"
