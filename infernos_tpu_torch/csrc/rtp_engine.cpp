// Native media-plane engine: G.711 / G.722 codecs, RTP packetizer, jitter
// buffer.  C ABI for ctypes binding (no pybind11 in this image).
//
// Capability parity: replaces the reference's C dependencies -- rtpsynth's
// RtpJBuf/RtpSynth (RTP/InfernRTPIngest.py:6, RTP/RTPOutputWorker.py:8), the
// G722 module (Core/Codecs/G722.py:1), and audioop's G.711 tables
// (Core/Codecs/G711.py:7-19).  Behavior matches the Python oracles in
// media/{jitter,rtp}.py and audio/codecs/ of this package -- the tests
// cross-check them byte-for-byte.
//
// Built by media/native.py: g++ -O3 -shared -fPIC -std=c++17 -pthread into
// build/librtpengine.so, through a temporary name.

#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

// pacer loop
#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/timerfd.h>
#include <pthread.h>
#include <sched.h>
#include <sys/resource.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>

extern "C" {

// ---------------------------------------------------------------------------
// G.711 mu-law / A-law (CCITT, matching CPython audioop semantics)
// ---------------------------------------------------------------------------

static const int16_t SEG_UEND[8] = {0x3F, 0x7F, 0xFF, 0x1FF,
                                    0x3FF, 0x7FF, 0xFFF, 0x1FFF};
static const int16_t SEG_AEND[8] = {0x1F, 0x3F, 0x7F, 0xFF,
                                    0x1FF, 0x3FF, 0x7FF, 0xFFF};

static inline int seg_search(int val, const int16_t *tab) {
  for (int i = 0; i < 8; i++)
    if (val <= tab[i]) return i;
  return 8;
}

static uint8_t lin2ulaw_one(int pcm) {
  pcm >>= 2;  // 14-bit domain
  int mask = 0xFF;
  if (pcm < 0) {
    pcm = -pcm;
    mask = 0x7F;
  }
  if (pcm > 8159) pcm = 8159;
  pcm += 0x84 >> 2;
  int seg = seg_search(pcm, SEG_UEND);
  if (seg >= 8) return 0x7F ^ mask;
  return ((seg << 4) | ((pcm >> (seg + 1)) & 0xF)) ^ mask;
}

static int16_t ulaw2lin_one(uint8_t u) {
  int v = ~u & 0xFF;
  int t = ((v & 0xF) << 3) + 0x84;
  t <<= (v & 0x70) >> 4;
  return (v & 0x80) ? (0x84 - t) : (t - 0x84);
}

static uint8_t lin2alaw_one(int pcm) {
  pcm >>= 3;  // 13-bit domain
  int mask;
  if (pcm >= 0) {
    mask = 0xD5;
  } else {
    mask = 0x55;
    pcm = -pcm - 1;
  }
  int seg = seg_search(pcm, SEG_AEND);
  if (seg >= 8) return 0x7F ^ mask;
  int shift = seg < 2 ? 1 : seg;
  return ((seg << 4) | ((pcm >> shift) & 0xF)) ^ mask;
}

static int16_t alaw2lin_one(uint8_t a) {
  int v = (a ^ 0x55) & 0xFF;
  int t = (v & 0xF) << 4;
  int seg = (v & 0x70) >> 4;
  if (seg == 0)
    t += 8;
  else if (seg == 1)
    t += 0x108;
  else
    t = (t + 0x108) << (seg - 1);
  return (v & 0x80) ? t : -t;
}

void g711_ulaw_encode(const int16_t *pcm, uint8_t *out, int n) {
  for (int i = 0; i < n; i++) out[i] = lin2ulaw_one(pcm[i]);
}
void g711_ulaw_decode(const uint8_t *in, int16_t *pcm, int n) {
  static int16_t table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) table[i] = ulaw2lin_one((uint8_t)i);
    init = true;
  }
  for (int i = 0; i < n; i++) pcm[i] = table[in[i]];
}
void g711_alaw_encode(const int16_t *pcm, uint8_t *out, int n) {
  for (int i = 0; i < n; i++) out[i] = lin2alaw_one(pcm[i]);
}
void g711_alaw_decode(const uint8_t *in, int16_t *pcm, int n) {
  static int16_t table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) table[i] = alaw2lin_one((uint8_t)i);
    init = true;
  }
  for (int i = 0; i < n; i++) pcm[i] = table[in[i]];
}

// ---------------------------------------------------------------------------
// G.722 (ITU-T, 64 kbit/s mode 1) -- port of the Python oracle
// ---------------------------------------------------------------------------

static const int Q6[30] = {0,    35,   72,   110,  150,  190,  233,  276,
                           323,  370,  422,  473,  530,  587,  650,  714,
                           786,  858,  940,  1023, 1121, 1219, 1339, 1458,
                           1612, 1765, 1980, 2195, 2557, 2919};
static const int ILN[32] = {0,  63, 62, 31, 30, 29, 28, 27, 26, 25, 24,
                            23, 22, 21, 20, 19, 18, 17, 16, 15, 14, 13,
                            12, 11, 10, 9,  8,  7,  6,  5,  4,  0};
static const int ILP[32] = {0,  61, 60, 59, 58, 57, 56, 55, 54, 53, 52,
                            51, 50, 49, 48, 47, 46, 45, 44, 43, 42, 41,
                            40, 39, 38, 37, 36, 35, 34, 33, 32, 0};
static const int WL[8] = {-60, -30, 58, 172, 334, 538, 1198, 3042};
static const int RL42[16] = {0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0};
static const int ILB[32] = {2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383,
                            2435, 2489, 2543, 2599, 2656, 2714, 2774, 2834,
                            2896, 2960, 3025, 3091, 3158, 3228, 3298, 3371,
                            3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008};
static const int QM2[4] = {-7408, -1616, 7408, 1616};
static const int QM4[16] = {0,     -20456, -12896, -8968, -6288, -4240,
                            -2584, -1200,  20456,  12896, 8968,  6288,
                            4240,  2584,   1200,   0};
static const int QM6[64] = {
    -136,   -136,   -136,   -136,   -24808, -21904, -19008, -16704,
    -14984, -13512, -12280, -11192, -10232, -9360,  -8576,  -7856,
    -7192,  -6576,  -6000,  -5456,  -4944,  -4464,  -4008,  -3576,
    -3168,  -2776,  -2400,  -2032,  -1688,  -1360,  -1040,  -728,
    24808,  21904,  19008,  16704,  14984,  13512,  12280,  11192,
    10232,  9360,   8576,   7856,   7192,   6576,   6000,   5456,
    4944,   4464,   4008,   3576,   3168,   2776,   2400,   2032,
    1688,   1360,   1040,   728,    432,    136,    -432,   -136};
static const int IHN[3] = {0, 1, 0};
static const int IHP[3] = {0, 3, 2};
static const int WH[3] = {0, -214, 798};
static const int RH2[4] = {2, 1, 2, 1};
static const int QMF[12] = {3,   -11, 12,   32,  -210, 951,
                            3876, -805, 362, -156, 53,  -11};

static inline int sat16(int x) {
  return x > 32767 ? 32767 : (x < -32768 ? -32768 : x);
}

struct G722Band {
  int s, sp, sz;
  int r[3], a[3], ap[3], p[3];
  int d[7], b[7], bp[7], sg[7];
  int nb, det;
};

struct G722State {
  G722Band band[2];
  int x[24];
};

static void band_init(G722Band *b, int det) {
  memset(b, 0, sizeof(*b));
  b->det = det;
}

void *g722_new() {
  G722State *s = new G722State();
  band_init(&s->band[0], 32);
  band_init(&s->band[1], 8);
  memset(s->x, 0, sizeof(s->x));
  return s;
}

void g722_free(void *p) { delete (G722State *)p; }

static void block4(G722Band *b, int d) {
  b->d[0] = d;
  b->r[0] = sat16(b->s + d);
  b->p[0] = sat16(b->sz + d);
  for (int i = 0; i < 3; i++) b->sg[i] = b->p[i] >> 15;
  int wd1 = sat16(b->a[1] * 4);
  int wd2 = (b->sg[0] == b->sg[1]) ? -wd1 : wd1;
  if (wd2 > 32767) wd2 = 32767;
  int wd3 = (wd2 >> 7) + ((b->sg[0] == b->sg[2]) ? 128 : -128);
  wd3 += (b->a[2] * 32512) >> 15;
  if (wd3 > 12288) wd3 = 12288;
  if (wd3 < -12288) wd3 = -12288;
  b->ap[2] = wd3;
  b->sg[0] = b->p[0] >> 15;
  b->sg[1] = b->p[1] >> 15;
  wd1 = (b->sg[0] == b->sg[1]) ? 192 : -192;
  wd2 = (b->a[1] * 32640) >> 15;
  b->ap[1] = sat16(wd1 + wd2);
  wd3 = sat16(15360 - b->ap[2]);
  if (b->ap[1] > wd3) b->ap[1] = wd3;
  else if (b->ap[1] < -wd3) b->ap[1] = -wd3;
  wd1 = (d == 0) ? 0 : 128;
  b->sg[0] = d >> 15;
  for (int i = 1; i < 7; i++) {
    b->sg[i] = b->d[i] >> 15;
    wd2 = (b->sg[i] == b->sg[0]) ? wd1 : -wd1;
    wd3 = (b->b[i] * 32640) >> 15;
    b->bp[i] = sat16(wd2 + wd3);
  }
  for (int i = 6; i > 0; i--) {
    b->d[i] = b->d[i - 1];
    b->b[i] = b->bp[i];
  }
  for (int i = 2; i > 0; i--) {
    b->r[i] = b->r[i - 1];
    b->p[i] = b->p[i - 1];
    b->a[i] = b->ap[i];
  }
  int sz = 0;
  for (int i = 6; i > 0; i--) sz += (b->b[i] * sat16(b->d[i] * 2)) >> 15;
  b->sz = sat16(sz);
  int sp = (b->a[1] * sat16(b->r[1] * 2)) >> 15;
  sp += (b->a[2] * sat16(b->r[2] * 2)) >> 15;
  b->sp = sat16(sp);
  b->s = sat16(b->sp + b->sz);
}

static void scale(G722Band *b, int shift_base) {
  int wd1 = (b->nb >> 6) & 31;
  int wd2 = shift_base - (b->nb >> 11);
  int wd3 = wd2 < 0 ? (ILB[wd1] << -wd2) : (ILB[wd1] >> wd2);
  b->det = wd3 << 2;
}

static void logscl(G722Band *b, int il4, int nb_max) {
  int wd = (b->nb * 127) >> 7;
  b->nb = wd + WL[il4];
  if (b->nb < 0) b->nb = 0;
  if (b->nb > nb_max) b->nb = nb_max;
  scale(b, 8);
}

static void logsch(G722Band *b, int ih2) {
  int wd = (b->nb * 127) >> 7;
  b->nb = wd + WH[ih2];
  if (b->nb < 0) b->nb = 0;
  if (b->nb > 22528) b->nb = 22528;
  scale(b, 10);
}

int g722_encode(void *state, const int16_t *pcm, int n, uint8_t *out) {
  G722State *s = (G722State *)state;
  G722Band *lo = &s->band[0], *hi = &s->band[1];
  int k = 0;
  for (int j = 0; j + 1 < n; j += 2) {
    memmove(s->x, s->x + 2, 22 * sizeof(int));
    s->x[22] = pcm[j];
    s->x[23] = pcm[j + 1];
    long sumodd = 0, sumeven = 0;
    for (int i = 0; i < 12; i++) {
      sumodd += (long)s->x[2 * i] * QMF[i];
      sumeven += (long)s->x[2 * i + 1] * QMF[11 - i];
    }
    int xlow = (int)((sumeven + sumodd) >> 14);
    int xhigh = (int)((sumeven - sumodd) >> 14);
    // low band
    int el = sat16(xlow - lo->s);
    int wd = el >= 0 ? el : -(el + 1);
    int i1 = 30;
    for (int i = 1; i < 30; i++) {
      if (wd < ((Q6[i] * lo->det) >> 12)) {
        i1 = i;
        break;
      }
    }
    int ilow = el < 0 ? ILN[i1] : ILP[i1];
    int ril = ilow >> 2;
    int dlowt = (lo->det * QM4[ril]) >> 15;
    logscl(lo, RL42[ril], 18432);
    block4(lo, dlowt);
    // high band
    int eh = sat16(xhigh - hi->s);
    wd = eh >= 0 ? eh : -(eh + 1);
    int mih = (wd >= ((564 * hi->det) >> 12)) ? 2 : 1;
    int ihigh = eh < 0 ? IHN[mih] : IHP[mih];
    int dhigh = (hi->det * QM2[ihigh]) >> 15;
    logsch(hi, RH2[ihigh]);
    block4(hi, dhigh);
    out[k++] = (uint8_t)((ihigh << 6) | ilow);
  }
  return k;
}

int g722_decode(void *state, const uint8_t *in, int n, int16_t *pcm) {
  G722State *s = (G722State *)state;
  G722Band *lo = &s->band[0], *hi = &s->band[1];
  int k = 0;
  for (int j = 0; j < n; j++) {
    int code = in[j];
    int ilow = code & 0x3F;
    int ihigh = (code >> 6) & 0x03;
    int rlow = lo->s + ((lo->det * QM6[ilow]) >> 15);
    if (rlow > 16383) rlow = 16383;
    if (rlow < -16384) rlow = -16384;
    int ril = ilow >> 2;
    int dlowt = (lo->det * QM4[ril]) >> 15;
    logscl(lo, RL42[ril], 18432);
    block4(lo, dlowt);
    int dhigh = (hi->det * QM2[ihigh]) >> 15;
    int rhigh = dhigh + hi->s;
    if (rhigh > 16383) rhigh = 16383;
    if (rhigh < -16384) rhigh = -16384;
    logsch(hi, RH2[ihigh]);
    block4(hi, dhigh);
    memmove(s->x, s->x + 2, 22 * sizeof(int));
    s->x[22] = rlow + rhigh;
    s->x[23] = rlow - rhigh;
    long xout2 = 0, xout1 = 0;
    for (int i = 0; i < 12; i++) {
      xout2 += (long)s->x[2 * i] * QMF[i];
      xout1 += (long)s->x[2 * i + 1] * QMF[11 - i];
    }
    pcm[k++] = (int16_t)sat16((int)(xout1 >> 11));
    pcm[k++] = (int16_t)sat16((int)(xout2 >> 11));
  }
  return k;
}

// ---------------------------------------------------------------------------
// RTP packetizer
// ---------------------------------------------------------------------------

struct RtpPacketizer {
  uint32_t clock_rate, ts_per_pkt, ssrc, ts;
  uint16_t seq;
  bool marker_next;
};

void *rtp_packetizer_new(uint32_t clock_rate, uint32_t ptime_ms, uint32_t ssrc,
                         uint16_t seq0, uint32_t ts0) {
  RtpPacketizer *p = new RtpPacketizer();
  p->clock_rate = clock_rate;
  p->ts_per_pkt = clock_rate * ptime_ms / 1000;
  p->ssrc = ssrc;
  p->seq = seq0;
  p->ts = ts0;
  p->marker_next = true;
  return p;
}

void rtp_packetizer_free(void *p) { delete (RtpPacketizer *)p; }

int rtp_next_pkt(void *state, uint32_t nsamples, uint8_t pt,
                 const uint8_t *payload, int payload_len, uint8_t *out) {
  RtpPacketizer *p = (RtpPacketizer *)state;
  out[0] = 2 << 6;
  out[1] = (p->marker_next ? 0x80 : 0) | (pt & 0x7F);
  out[2] = p->seq >> 8;
  out[3] = p->seq & 0xFF;
  out[4] = p->ts >> 24;
  out[5] = (p->ts >> 16) & 0xFF;
  out[6] = (p->ts >> 8) & 0xFF;
  out[7] = p->ts & 0xFF;
  out[8] = p->ssrc >> 24;
  out[9] = (p->ssrc >> 16) & 0xFF;
  out[10] = (p->ssrc >> 8) & 0xFF;
  out[11] = p->ssrc & 0xFF;
  memcpy(out + 12, payload, payload_len);
  p->marker_next = false;
  p->seq++;
  p->ts += nsamples;
  return 12 + payload_len;
}

void rtp_skip(void *state, uint32_t npkts) {
  RtpPacketizer *p = (RtpPacketizer *)state;
  p->ts += npkts * p->ts_per_pkt;
  p->marker_next = true;
}

// Current media-clock timestamp (advances across idle skips); feeds the
// RTCP SR rtp_ts field on the Python side.
uint32_t rtp_packetizer_ts(void *state) {
  return ((RtpPacketizer *)state)->ts;
}

// ---------------------------------------------------------------------------
// Jitter buffer (same contract as media/jitter.py)
// ---------------------------------------------------------------------------

struct JBuf {
  int size;  // MAX reorder depth; effective depth adapts (see Python oracle)
  bool have_ssrc, have_base, have_last_ts;
  uint32_t ssrc;
  int64_t cycles;
  int last_seq;  // -1 = none
  int64_t next_eseq;  // -1 = none
  uint32_t last_ts;
  int last_dur;
  double reorder_depth;  // decaying max of observed reorder distance
  int64_t max_eseq;      // -1 = none
  std::map<int64_t, std::vector<uint8_t>> buf;  // eseq -> parsed payload
  std::map<int64_t, std::pair<uint32_t, bool>> meta;  // eseq -> (ts, marker)
};

void *jbuf_new(int size) {
  JBuf *j = new JBuf();
  j->size = size;
  j->have_ssrc = j->have_base = j->have_last_ts = false;
  j->cycles = 0;
  j->last_seq = -1;
  j->next_eseq = -1;
  j->last_dur = 0;
  j->reorder_depth = 0.0;
  j->max_eseq = -1;
  return j;
}

void jbuf_free(void *p) { delete (JBuf *)p; }

static int64_t jb_extend(JBuf *j, int seq) {
  if (j->last_seq < 0) {
    j->last_seq = seq;
    return j->cycles + seq;
  }
  int delta = (seq - j->last_seq) & 0xFFFF;
  if (delta < 0x8000) {
    if (seq < j->last_seq) j->cycles += 0x10000;
    j->last_seq = seq;
    return j->cycles + seq;
  }
  if (seq > j->last_seq) return j->cycles - 0x10000 + seq;
  return j->cycles + seq;
}

// Output record layout (packed little-endian):
//   uint8  type        (0 = audio, 1 = ERS)
//   int64  lseq        (audio) / lseq_end (ERS)
//   int64  lseq_start  (ERS; 0 for audio)
//   uint32 ts_diff     (ERS; 0 for audio)
//   uint32 payload_len
//   uint8  payload[payload_len]
static int emit_audio(uint8_t *out, int off, int64_t lseq,
                      const std::vector<uint8_t> &payload) {
  out[off] = 0;
  memcpy(out + off + 1, &lseq, 8);
  int64_t zero64 = 0;
  memcpy(out + off + 9, &zero64, 8);
  uint32_t zero32 = 0;
  memcpy(out + off + 17, &zero32, 4);
  uint32_t len = (uint32_t)payload.size();
  memcpy(out + off + 21, &len, 4);
  memcpy(out + off + 25, payload.data(), len);
  return off + 25 + (int)len;
}

static int emit_ers(uint8_t *out, int off, int64_t lseq_start,
                    int64_t lseq_end, uint32_t ts_diff) {
  out[off] = 1;
  memcpy(out + off + 1, &lseq_end, 8);
  memcpy(out + off + 9, &lseq_start, 8);
  memcpy(out + off + 17, &ts_diff, 4);
  uint32_t zero = 0;
  memcpy(out + off + 21, &zero, 4);
  return off + 25;
}

// Returns bytes written to out (records), or -1 on parse error.
int jbuf_udp_in(void *state, const uint8_t *data, int len, uint8_t *out,
                int out_cap) {
  JBuf *j = (JBuf *)state;
  if (len < 12) return -1;
  int version = data[0] >> 6;
  if (version != 2) return -1;
  int cc = data[0] & 0x0F;
  bool ext = data[0] & 0x10;
  bool padding = data[0] & 0x20;
  bool marker = data[1] & 0x80;
  uint16_t seq = (data[2] << 8) | data[3];
  uint32_t ts = ((uint32_t)data[4] << 24) | (data[5] << 16) | (data[6] << 8) |
                data[7];
  uint32_t ssrc = ((uint32_t)data[8] << 24) | (data[9] << 16) |
                  (data[10] << 8) | data[11];
  int off = 12 + 4 * cc;
  if (ext) {
    if (len < off + 4) return -1;
    int xlen = (data[off + 2] << 8) | data[off + 3];
    off += 4 + 4 * xlen;
  }
  if (len < off) return -1;
  int plen = len - off;
  if (padding && plen > 0) {
    int pad = data[len - 1];
    if (pad == 0 || pad > plen) return -1;
    plen -= pad;
  }
  if (!j->have_ssrc) {
    j->have_ssrc = true;
    j->ssrc = ssrc;
  } else if (ssrc != j->ssrc) {
    // SSRC change: reset stream state
    j->buf.clear();
    j->meta.clear();
    j->cycles = 0;
    j->last_seq = -1;
    j->next_eseq = -1;
    j->have_last_ts = false;
    j->reorder_depth = 0.0;
    j->max_eseq = -1;
    j->ssrc = ssrc;
  }
  int64_t eseq = jb_extend(j, seq);
  // adaptive depth bookkeeping (identical rule to the Python oracle)
  if (j->max_eseq < 0 || eseq > j->max_eseq) {
    j->max_eseq = eseq;
  } else {
    double dist = (double)(j->max_eseq - eseq);
    if (dist > j->reorder_depth) j->reorder_depth = dist;
  }
  j->reorder_depth *= 0.995;
  if (j->next_eseq < 0) j->next_eseq = eseq;
  if (eseq < j->next_eseq || j->buf.count(eseq)) return 0;
  j->buf[eseq] = std::vector<uint8_t>(data + off, data + off + plen);
  j->meta[eseq] = {ts, marker};

  int w = 0;
  while (!j->buf.empty()) {
    auto it = j->buf.find(j->next_eseq);
    if (it != j->buf.end()) {
      auto &payload = it->second;
      if (w + 25 + (int)payload.size() > out_cap) break;
      w = emit_audio(out, w, j->next_eseq, payload);
      j->last_ts = j->meta[j->next_eseq].first;
      j->last_dur = (int)payload.size();
      j->have_last_ts = true;
      j->meta.erase(j->next_eseq);
      j->buf.erase(it);
      j->next_eseq++;
      continue;
    }
    {
      int eff = (int)j->reorder_depth + 1;
      if (eff < 2) eff = 2;
      if (eff > j->size) eff = j->size;
      if ((int)j->buf.size() < eff) break;
    }
    int64_t first_avail = j->buf.begin()->first;
    uint32_t first_ts = j->meta[first_avail].first;
    uint32_t ts_diff;
    if (j->have_last_ts) {
      ts_diff = first_ts - (j->last_ts + j->last_dur);
      if (ts_diff > (1u << 30))
        ts_diff = (uint32_t)((first_avail - j->next_eseq) * j->last_dur);
    } else {
      ts_diff = (uint32_t)((first_avail - j->next_eseq) *
                           (int)j->buf.begin()->second.size());
    }
    if (w + 25 > out_cap) break;
    w = emit_ers(out, w, j->next_eseq, first_avail - 1, ts_diff);
    j->next_eseq = first_avail;
  }
  return w;
}


// ---------------------------------------------------------------------------
// Paced egress loop: ONE timerfd/epoll thread paces ALL legs.
//
// Replaces the reference's thread-per-leg sleep pacing
// (RTP/RTPOutputWorker.py:126-149) and the elperiodic C library
// (HelloSippyTTSRT/HelloSippyRTPipeTest.py:31).  Python writes encoded
// payload bytes per leg; this loop emits one RTP packet per ptime on a
// monotonic absolute-deadline schedule (no drift), skips the timestamp on
// idle ticks (talkspurt marker on resume, same as rtp_skip semantics), and
// records the deviation of each send from its deadline as a jitter
// histogram for SLA verification.
// ---------------------------------------------------------------------------

struct PacerLeg {
  int fd;  // borrowed socket fd (not closed on removal)
  sockaddr_in dest;
  bool have_dest;
  uint64_t ptime_ns;
  uint32_t frame_bytes;      // encoded payload bytes per packet
  uint32_t samples_per_pkt;  // RTP timestamp increment per packet
  uint8_t pt;
  RtpPacketizer pkt;
  std::deque<uint8_t> buf;
  uint64_t next_deadline;  // ns monotonic; 0 = cadence not running
  uint64_t sent_bytes, sent_pkts, skipped;
  uint32_t idle_ticks;
  // |send - deadline| histogram
  uint64_t jit_le_500us, jit_le_1ms, jit_le_2ms, jit_le_5ms, jit_gt_5ms;
  uint64_t jit_max_ns;
};

struct Pacer {
  int epfd, tfd, evfd;
  std::thread thr;
  std::mutex mu;
  std::unordered_map<int, PacerLeg *> legs;
  int next_id;
  std::atomic<bool> stopping;
  uint32_t idle_suspend_ticks;  // suspend cadence after this many idle skips
};

static inline uint64_t now_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
}

static void pacer_wake(Pacer *p) {
  uint64_t one = 1;
  ssize_t r = write(p->evfd, &one, sizeof(one));
  (void)r;
}

static void pacer_send_due(Pacer *p, uint64_t now) {
  for (auto &kv : p->legs) {
    PacerLeg *l = kv.second;
    if (l->next_deadline == 0) continue;
    while (l->next_deadline <= now) {
      if (l->buf.size() >= l->frame_bytes) {
        uint8_t payload[2048];
        uint32_t n = l->frame_bytes;
        for (uint32_t i = 0; i < n; i++) {
          payload[i] = l->buf.front();
          l->buf.pop_front();
        }
        uint8_t out[2100];
        int len = rtp_next_pkt(&l->pkt, l->samples_per_pkt, l->pt, payload,
                               (int)n, out);
        if (l->have_dest && l->fd >= 0) {
          sendto(l->fd, out, len, MSG_DONTWAIT,
                 (const sockaddr *)&l->dest, sizeof(l->dest));
        }
        uint64_t dev = now - l->next_deadline;
        if (dev > l->jit_max_ns) l->jit_max_ns = dev;
        if (dev <= 500000ull) l->jit_le_500us++;
        else if (dev <= 1000000ull) l->jit_le_1ms++;
        else if (dev <= 2000000ull) l->jit_le_2ms++;
        else if (dev <= 5000000ull) l->jit_le_5ms++;
        else l->jit_gt_5ms++;
        l->sent_pkts++;
        l->sent_bytes += n;
        l->idle_ticks = 0;
      } else {
        rtp_skip(&l->pkt, 1);
        l->skipped++;
        if (++l->idle_ticks >= p->idle_suspend_ticks) {
          l->next_deadline = 0;  // suspend cadence; next write restarts it
          l->idle_ticks = 0;
          break;
        }
      }
      if (l->next_deadline) l->next_deadline += l->ptime_ns;
    }
  }
}

static void pacer_loop(Pacer *p) {
  // Hard-real-time egress: try to elevate this thread above ordinary
  // compute threads (JAX compiles, engine drivers) so 20 ms deadlines hold
  // under host load.  SCHED_FIFO needs CAP_SYS_NICE; fall back to a negative
  // nice value, and to nothing when unprivileged -- pacing still works, the
  // jitter SLA just becomes load-dependent.
  struct sched_param sp;
  memset(&sp, 0, sizeof(sp));
  sp.sched_priority = 10;
  if (pthread_setschedparam(pthread_self(), SCHED_FIFO, &sp) != 0) {
    setpriority(PRIO_PROCESS, (id_t)syscall(SYS_gettid), -15);
  }
  struct epoll_event evs[4];
  while (!p->stopping.load()) {
    uint64_t next = 0;
    {
      std::lock_guard<std::mutex> g(p->mu);
      uint64_t now = now_ns();
      pacer_send_due(p, now);
      for (auto &kv : p->legs) {
        PacerLeg *l = kv.second;
        if (l->next_deadline && (next == 0 || l->next_deadline < next))
          next = l->next_deadline;
      }
    }
    struct itimerspec its;
    memset(&its, 0, sizeof(its));
    if (next) {
      its.it_value.tv_sec = next / 1000000000ull;
      its.it_value.tv_nsec = next % 1000000000ull;
      timerfd_settime(p->tfd, TFD_TIMER_ABSTIME, &its, nullptr);
    } else {
      timerfd_settime(p->tfd, 0, &its, nullptr);  // disarm
    }
    int n = epoll_wait(p->epfd, evs, 4, next ? 1000 : -1);
    for (int i = 0; i < n; i++) {
      uint64_t buf;
      ssize_t r = read(evs[i].data.fd, &buf, sizeof(buf));
      (void)r;
    }
  }
}

void *pacer_new(uint32_t idle_suspend_ticks) {
  Pacer *p = new Pacer();
  p->next_id = 1;
  p->stopping = false;
  p->idle_suspend_ticks = idle_suspend_ticks ? idle_suspend_ticks : 250;
  p->epfd = epoll_create1(0);
  p->tfd = timerfd_create(CLOCK_MONOTONIC, TFD_NONBLOCK);
  p->evfd = eventfd(0, EFD_NONBLOCK);
  struct epoll_event ev;
  memset(&ev, 0, sizeof(ev));
  ev.events = EPOLLIN;
  ev.data.fd = p->tfd;
  epoll_ctl(p->epfd, EPOLL_CTL_ADD, p->tfd, &ev);
  ev.data.fd = p->evfd;
  epoll_ctl(p->epfd, EPOLL_CTL_ADD, p->evfd, &ev);
  p->thr = std::thread(pacer_loop, p);
  return p;
}

void pacer_free(void *vp) {
  Pacer *p = (Pacer *)vp;
  p->stopping = true;
  pacer_wake(p);
  p->thr.join();
  for (auto &kv : p->legs) delete kv.second;
  close(p->epfd);
  close(p->tfd);
  close(p->evfd);
  delete p;
}

int pacer_add_leg(void *vp, int fd, uint32_t clock_rate, uint32_t ptime_ms,
                  uint8_t pt, uint32_t frame_bytes, uint32_t samples_per_pkt,
                  uint32_t ssrc, uint16_t seq0, uint32_t ts0) {
  Pacer *p = (Pacer *)vp;
  PacerLeg *l = new PacerLeg();
  l->fd = fd;
  l->have_dest = false;
  l->ptime_ns = (uint64_t)ptime_ms * 1000000ull;
  l->frame_bytes = frame_bytes;
  l->samples_per_pkt = samples_per_pkt;
  l->pt = pt;
  l->pkt.clock_rate = clock_rate;
  l->pkt.ts_per_pkt = samples_per_pkt;
  l->pkt.ssrc = ssrc;
  l->pkt.seq = seq0;
  l->pkt.ts = ts0;
  l->pkt.marker_next = true;
  l->next_deadline = 0;
  l->sent_bytes = l->sent_pkts = l->skipped = 0;
  l->idle_ticks = 0;
  l->jit_le_500us = l->jit_le_1ms = l->jit_le_2ms = l->jit_le_5ms =
      l->jit_gt_5ms = 0;
  l->jit_max_ns = 0;
  std::lock_guard<std::mutex> g(p->mu);
  int id = p->next_id++;
  p->legs[id] = l;
  return id;
}

void pacer_set_dest(void *vp, int leg, const char *ip, uint16_t port) {
  Pacer *p = (Pacer *)vp;
  std::lock_guard<std::mutex> g(p->mu);
  auto it = p->legs.find(leg);
  if (it == p->legs.end()) return;
  memset(&it->second->dest, 0, sizeof(it->second->dest));
  it->second->dest.sin_family = AF_INET;
  it->second->dest.sin_port = htons(port);
  inet_pton(AF_INET, ip, &it->second->dest.sin_addr);
  it->second->have_dest = true;
}

void pacer_remove_leg(void *vp, int leg) {
  Pacer *p = (Pacer *)vp;
  std::lock_guard<std::mutex> g(p->mu);
  auto it = p->legs.find(leg);
  if (it == p->legs.end()) return;
  delete it->second;
  p->legs.erase(it);
}

void pacer_write(void *vp, int leg, const uint8_t *data, int len) {
  Pacer *p = (Pacer *)vp;
  bool wake = false;
  {
    std::lock_guard<std::mutex> g(p->mu);
    auto it = p->legs.find(leg);
    if (it == p->legs.end()) return;
    PacerLeg *l = it->second;
    l->buf.insert(l->buf.end(), data, data + len);
    if (l->next_deadline == 0) {
      l->next_deadline = now_ns();
      wake = true;
    } else {
      wake = true;  // re-arm in case the loop sleeps past this leg
    }
  }
  if (wake) pacer_wake(p);
}

uint64_t pacer_leg_sent_bytes(void *vp, int leg) {
  Pacer *p = (Pacer *)vp;
  std::lock_guard<std::mutex> g(p->mu);
  auto it = p->legs.find(leg);
  return it == p->legs.end() ? 0 : it->second->sent_bytes;
}

uint64_t pacer_leg_buffered(void *vp, int leg) {
  Pacer *p = (Pacer *)vp;
  std::lock_guard<std::mutex> g(p->mu);
  auto it = p->legs.find(leg);
  return it == p->legs.end() ? 0 : it->second->buf.size();
}

// out[10]: sent_pkts, skipped, jit<=0.5ms, <=1ms, <=2ms, <=5ms, >5ms,
//          jit_max_ns, sent_bytes, rtp_ts (current media-clock timestamp;
//          advances across idle skips, so RTCP SR NTP<->RTP mapping holds)
void pacer_leg_stats(void *vp, int leg, uint64_t *out) {
  Pacer *p = (Pacer *)vp;
  std::lock_guard<std::mutex> g(p->mu);
  auto it = p->legs.find(leg);
  if (it == p->legs.end()) {
    memset(out, 0, 10 * sizeof(uint64_t));
    return;
  }
  PacerLeg *l = it->second;
  out[0] = l->sent_pkts;
  out[1] = l->skipped;
  out[2] = l->jit_le_500us;
  out[3] = l->jit_le_1ms;
  out[4] = l->jit_le_2ms;
  out[5] = l->jit_le_5ms;
  out[6] = l->jit_gt_5ms;
  out[7] = l->jit_max_ns;
  out[8] = l->sent_bytes;
  out[9] = l->pkt.ts;
}

}  // extern "C"
