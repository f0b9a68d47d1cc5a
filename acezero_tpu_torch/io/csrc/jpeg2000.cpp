// Host JPEG 2000 codec with a plain C interface, loaded with ctypes by
// acezero_tpu_torch/io/jpeg2000.py, built by acezero_tpu_torch/ops/build.py.
//
// acz_j2k_decode decodes a part-1 codestream (ISO/IEC 15444-1) to the
// component samples openjpeg 2.5's tile decoder hands PIL (after the
// inverse wavelet, the inverse component transform, the DC level shift and
// the clamp to each component's precision), tile by tile into planes of the
// image's size:
//   - main and tile-part headers: SIZ (image and tile offsets), COD/COC,
//     QCD/QCC (no quantisation and scalar expounded), COM, TLM, PLM, PLT,
//     SOT/SOD/EOC; tile-parts of a tile in order, any number of tiles;
//   - tier-2: packet headers with their bit stuffing, inclusion and
//     zero-bit-plane tag trees, coding-pass counts and length indicators,
//     precincts of any size, any number of quality layers, the five
//     progression orders as openjpeg's packet iterator steps through them;
//   - tier-1: the MQ decoder (openjpeg's two 0xFF bytes after each
//     code-block's data) and the three coding passes of code-block style 0
//     in openjpeg's numbering of the bit-planes: a coefficient keeps one bit
//     below each decoded plane set (the mid-point reconstruction), and the
//     last plane decoded is 1, whatever the pass count says; the result
//     halved for the 5/3 path and scaled by half the step size for the 9/7
//     path;
//   - the inverse 5/3 wavelet in integers and the 9/7 in float32, rows then
//     columns at each level, in openjpeg's order of operations (its 2/K on
//     the high-pass samples, with the step sizes of every band taken at
//     gain 0); RCT and ICT; the level shift with lrintf on the 9/7 path.
// Whatever Pillow's encoder cannot write is refused by name ("... not read
// yet"): code-block styles other than 0, RGN, POC, PPM/PPT, SOP/EPH,
// scalar derived quantisation, sub-sampled components, part-2 and HTJ2K
// codestreams. Every inconsistency raises, also where openjpeg reads on (a
// packet past its tile's data, a missing tile): the caller then refuses
// the file rather than give other pixels than PIL.
//
// acz_j2k_encode writes a lossless codestream: one tile, one quality layer,
// LRCP, the 5/3 wavelet without a component transform, 64 x 64 code-blocks
// in precincts of one code-block each (so every tag tree has one leaf), the
// MQ coder terminated once per code-block.
//
// Built with -ffp-contract=off (ops/build.py): no fused multiply-add, so
// the float path rounds as openjpeg's does on every host.

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[400];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{buf};
}

[[noreturn]] void unsupported(const char* feature) { fail("JPEG 2000 %s, not read yet", feature); }

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int b) { return (a + (int64_t(1) << b) - 1) >> b; }
int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ------------------------------------------------------------ the headers

constexpr int kMaxComps = 16384;
constexpr int kMaxRes = 33;
constexpr int kMaxBands = 3 * kMaxRes - 2;

struct Comp {
  int prec = 0;
  bool sgnd = false;
  int dx = 1, dy = 1;
};

struct CodingStyle {  // SPcod / SPcoc
  int nres = 0;  // decomposition levels + 1
  int cbw = 0, cbh = 0;  // code-block size exponents
  int cblksty = 0;
  int qmfbid = 0;  // 1: 5/3, 0: 9/7
  int prcw[kMaxRes], prch[kMaxRes];
};

struct Quant {  // SQcd / SQcc
  int qntsty = 0;
  int guard = 0;
  int nbands = 0;
  int expn[kMaxBands] = {};
  int mant[kMaxBands] = {};
};

struct TileParams {
  int csty = 0;  // Scod
  int prog = 0;
  int layers = 0;
  int mct = 0;
  std::vector<CodingStyle> cs;
  std::vector<Quant> q;
  bool cod = false, qcd = false;
  std::vector<bool> coc, qcc;
};

struct Image {
  int64_t x0, y0, x1, y1;  // image area on the reference grid
  int64_t tx0, ty0, tw, th;  // tile grid origin and size
  int64_t ntx, nty;
  std::vector<Comp> comps;
};

class Bytes {
 public:
  Bytes(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  size_t size() const { return n_; }
  int u8(size_t at) const {
    if (at >= n_) fail("marker segment cut short");
    return p_[at];
  }
  int u16(size_t at) const { return (u8(at) << 8) | u8(at + 1); }
  uint32_t u32(size_t at) const { return (uint32_t(u16(at)) << 16) | uint32_t(u16(at + 2)); }
  const uint8_t* ptr(size_t at) const { return p_ + at; }

 private:
  const uint8_t* p_;
  size_t n_;
};

void read_siz(const Bytes& b, size_t at, int len, Image& im) {
  if (len < 39) fail("SIZ marker segment too short");
  int rsiz = b.u16(at);
  if (rsiz & 0x4000) unsupported("HTJ2K codestream");
  if (rsiz & 0x8000) unsupported("part-2 codestream");
  uint32_t xsiz = b.u32(at + 2), ysiz = b.u32(at + 6), xosiz = b.u32(at + 10), yosiz = b.u32(at + 14);
  uint32_t xtsiz = b.u32(at + 18), ytsiz = b.u32(at + 22), xtosiz = b.u32(at + 26), ytosiz = b.u32(at + 30);
  int csiz = b.u16(at + 34);
  if (csiz == 0 || csiz > kMaxComps) fail("SIZ: %d components", csiz);
  if (len - 36 != 3 * csiz) fail("SIZ marker segment of %d bytes for %d components", len + 2, csiz);
  if (xosiz >= xsiz || yosiz >= ysiz) fail("SIZ: empty image");
  if (xtsiz == 0 || ytsiz == 0) fail("SIZ: tile of zero size");
  if (xtosiz > xosiz || ytosiz > yosiz || uint64_t(xtosiz) + xtsiz <= xosiz || uint64_t(ytosiz) + ytsiz <= yosiz)
    fail("SIZ: tile grid offset outside the first tile");
  im.x0 = xosiz;
  im.y0 = yosiz;
  im.x1 = xsiz;
  im.y1 = ysiz;
  im.tx0 = xtosiz;
  im.ty0 = ytosiz;
  im.tw = xtsiz;
  im.th = ytsiz;
  im.ntx = ceildiv(im.x1 - im.tx0, im.tw);
  im.nty = ceildiv(im.y1 - im.ty0, im.th);
  if (im.ntx * im.nty > 65535) fail("SIZ: %lld tiles", (long long)(im.ntx * im.nty));
  im.comps.resize(csiz);
  for (int c = 0; c < csiz; ++c) {
    int ssiz = b.u8(at + 36 + 3 * c);
    Comp& k = im.comps[c];
    k.prec = (ssiz & 0x7F) + 1;
    k.sgnd = ssiz >> 7;
    k.dx = b.u8(at + 37 + 3 * c);
    k.dy = b.u8(at + 38 + 3 * c);
    if (k.prec > 31) fail("SIZ: component %d of %d bits", c, k.prec);
    if (k.dx == 0 || k.dy == 0) fail("SIZ: component %d sub-sampled by zero", c);
    if (k.dx != 1 || k.dy != 1) unsupported("sub-sampled component");
  }
}

// SPcod or SPcoc, starting at the decomposition levels byte; returns the
// bytes read
int read_spcod(const Bytes& b, size_t at, int avail, bool precincts, CodingStyle& cs) {
  if (avail < 5) fail("COD/COC marker segment too short");
  int nl = b.u8(at);
  if (nl > 32) fail("COD/COC: %d decomposition levels", nl);
  cs.nres = nl + 1;
  cs.cbw = b.u8(at + 1) + 2;
  cs.cbh = b.u8(at + 2) + 2;
  if (cs.cbw > 10 || cs.cbh > 10 || cs.cbw + cs.cbh > 12) fail("COD/COC: code-block size exponents %d, %d", cs.cbw, cs.cbh);
  cs.cblksty = b.u8(at + 3);
  if (cs.cblksty & 0xC0) fail("COD/COC: code-block style 0x%02x", cs.cblksty);
  if (cs.cblksty & 0x40) unsupported("HTJ2K code-block");
  if (cs.cblksty) unsupported("code-block style other than 0");
  cs.qmfbid = b.u8(at + 4);
  if (cs.qmfbid > 1) fail("COD/COC: wavelet transform %d", cs.qmfbid);
  int n = 5;
  for (int r = 0; r < cs.nres; ++r) {
    if (precincts) {
      if (n >= avail) fail("COD/COC marker segment too short for its precincts");
      int v = b.u8(at + n++);
      cs.prcw[r] = v & 15;
      cs.prch[r] = v >> 4;
      if (r > 0 && (cs.prcw[r] == 0 || cs.prch[r] == 0)) fail("COD/COC: precinct size exponent 0");
    } else {
      cs.prcw[r] = cs.prch[r] = 15;
    }
  }
  return n;
}

int read_sqcd(const Bytes& b, size_t at, int avail, Quant& q) {
  if (avail < 1) fail("QCD/QCC marker segment too short");
  int s = b.u8(at);
  q.qntsty = s & 0x1F;
  q.guard = s >> 5;
  if (q.qntsty == 1) unsupported("scalar derived quantisation");
  if (q.qntsty == 0) {
    q.nbands = avail - 1;
    if (q.nbands > kMaxBands) fail("QCD/QCC: %d bands", q.nbands);
    for (int i = 0; i < q.nbands; ++i) {
      q.expn[i] = b.u8(at + 1 + i) >> 3;
      q.mant[i] = 0;
    }
  } else if (q.qntsty == 2) {
    if ((avail - 1) % 2) fail("QCD/QCC marker segment of odd length");
    q.nbands = (avail - 1) / 2;
    if (q.nbands > kMaxBands) fail("QCD/QCC: %d bands", q.nbands);
    for (int i = 0; i < q.nbands; ++i) {
      int v = b.u16(at + 1 + 2 * i);
      q.expn[i] = v >> 11;
      q.mant[i] = v & 0x7FF;
    }
  } else {
    fail("QCD/QCC: quantisation style %d", q.qntsty);
  }
  return avail;
}

// A marker segment of the main header or of a first tile-part's header
// that sets coding parameters
void read_param_marker(const Bytes& b, int marker, size_t at, int len, const Image& im, TileParams& tp) {
  int nc = int(im.comps.size());
  int avail = len - 2;
  size_t p = at + 2;
  switch (marker) {
    case 0xFF52: {  // COD
      if (tp.cod) fail("a second COD marker segment");
      if (avail < 5) fail("COD marker segment too short");
      tp.cod = true;
      tp.csty = b.u8(p);
      if (tp.csty & ~7) fail("COD: coding style 0x%02x", tp.csty);
      if (tp.csty & 6) unsupported("SOP or EPH marker");
      tp.prog = b.u8(p + 1);
      if (tp.prog > 4) fail("COD: progression order %d", tp.prog);
      tp.layers = b.u16(p + 2);
      if (tp.layers == 0) fail("COD: zero quality layers");
      tp.mct = b.u8(p + 4);
      if (tp.mct > 1) fail("COD: component transform %d", tp.mct);
      CodingStyle cs;
      int n = read_spcod(b, p + 5, avail - 5, tp.csty & 1, cs);
      if (5 + n != avail) fail("COD marker segment of %d bytes", len);
      for (int c = 0; c < nc; ++c) {
        if (tp.coc[c]) fail("a COC marker segment before the COD");
        tp.cs[c] = cs;
      }
      break;
    }
    case 0xFF53: {  // COC
      if (!tp.cod) fail("a COC marker segment before the COD");
      int w = nc <= 256 ? 1 : 2;
      if (avail < w + 1) fail("COC marker segment too short");
      int c = w == 1 ? b.u8(p) : b.u16(p);
      if (c >= nc) fail("COC for component %d of %d", c, nc);
      if (tp.coc[c]) fail("a second COC marker segment for component %d", c);
      tp.coc[c] = true;
      int scoc = b.u8(p + w);
      if (scoc & ~1) fail("COC: coding style 0x%02x", scoc);
      int n = read_spcod(b, p + w + 1, avail - w - 1, scoc & 1, tp.cs[c]);
      if (w + 1 + n != avail) fail("COC marker segment of %d bytes", len);
      break;
    }
    case 0xFF5C: {  // QCD
      if (tp.qcd) fail("a second QCD marker segment");
      tp.qcd = true;
      Quant q;
      read_sqcd(b, p, avail, q);
      for (int c = 0; c < nc; ++c) {
        if (tp.qcc[c]) fail("a QCC marker segment before the QCD");
        tp.q[c] = q;
      }
      break;
    }
    case 0xFF5D: {  // QCC
      if (!tp.qcd) fail("a QCC marker segment before the QCD");
      int w = nc <= 256 ? 1 : 2;
      if (avail < w + 1) fail("QCC marker segment too short");
      int c = w == 1 ? b.u8(p) : b.u16(p);
      if (c >= nc) fail("QCC for component %d of %d", c, nc);
      if (tp.qcc[c]) fail("a second QCC marker segment for component %d", c);
      tp.qcc[c] = true;
      read_sqcd(b, p + w, avail - w, tp.q[c]);
      break;
    }
    default:
      fail("marker 0x%04x", marker);
  }
}

bool is_param_marker(int m) { return m == 0xFF52 || m == 0xFF53 || m == 0xFF5C || m == 0xFF5D; }

void refuse_marker(int m) {
  switch (m) {
    case 0xFF5E: unsupported("RGN marker (region of interest)");
    case 0xFF5F: unsupported("POC marker (progression order change)");
    case 0xFF60: unsupported("PPM marker (packed packet headers)");
    case 0xFF61: unsupported("PPT marker (packed packet headers)");
    case 0xFF50: unsupported("CAP marker (part-15 capabilities)");
    case 0xFF59: unsupported("CPF marker (part-15 profile)");
    case 0xFF74: case 0xFF75: case 0xFF76: case 0xFF77: case 0xFF78:
      unsupported("part-2 marker");
    default:
      fail("unexpected marker 0x%04x", m);
  }
}

// ------------------------------------------------------------ tier-2

class BitReader {  // opj_bio, for packet headers
 public:
  BitReader(const uint8_t* p, size_t n) : start_(p), bp_(p), end_(p + n) {}
  int bit() {
    if (ct_ == 0) bytein();
    --ct_;
    return (buf_ >> ct_) & 1;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= uint32_t(bit()) << i;
    return v;
  }
  void inalign() {
    if ((buf_ & 0xFF) == 0xFF) bytein();
    ct_ = 0;
  }
  size_t consumed() const { return size_t(bp_ - start_); }
  bool overran() const { return overran_; }

 private:
  void bytein() {
    buf_ = (buf_ << 8) & 0xFFFF;
    ct_ = buf_ == 0xFF00 ? 7 : 8;
    if (bp_ < end_) {
      buf_ |= *bp_++;
    } else {
      overran_ = true;
    }
  }
  const uint8_t* start_;
  const uint8_t* bp_;
  const uint8_t* end_;
  uint32_t buf_ = 0;
  int ct_ = 0;
  bool overran_ = false;
};

struct TagTree {  // opj_tgt
  struct Node {
    int parent;
    int value, low;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw, lh;
    int cw = w, ch = h;
    int total = 0;
    while (true) {
      lw.push_back(cw);
      lh.push_back(ch);
      total += cw * ch;
      if (cw * ch <= 1) break;
      cw = (cw + 1) / 2;
      ch = (ch + 1) / 2;
    }
    nodes.assign(total, Node{-1, 999, 0});
    int base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      int nb = base + lw[l] * lh[l];
      for (int y = 0; y < lh[l]; ++y)
        for (int x = 0; x < lw[l]; ++x) nodes[base + y * lw[l] + x].parent = nb + (y / 2) * lw[l + 1] + x / 2;
      base = nb;
    }
  }
  // 1 when the leaf's value is below `threshold`
  int decode(BitReader& bio, int leaf, int threshold) {
    int stk[40];
    int sp = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[sp++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    while (true) {
      Node& n = nodes[node];
      if (low > n.low) {
        n.low = low;
      } else {
        low = n.low;
      }
      while (low < threshold && low < n.value) {
        if (bio.bit()) {
          n.value = low;
        } else {
          ++low;
        }
      }
      n.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return nodes[node].value < threshold ? 1 : 0;
  }
};

struct CodeBlock {
  int64_t x0, y0, x1, y1;  // band coordinates
  bool included = false;
  int numbps = 0;  // the first bit-plane, as openjpeg numbers it: band numbps + 1 - zero planes
  int lenbits = 3;
  int passes = 0;
  std::vector<uint8_t> data;
};

struct Precinct {  // one band's part of a precinct
  int cw = 0, ch = 0;
  std::vector<CodeBlock> blocks;
  TagTree incl, imsb;
};

struct Band {
  int orient = 0;  // 0 LL, 1 HL, 2 LH, 3 HH
  int64_t x0, y0, x1, y1;
  int numbps = 0;  // expn + guard - 1
  float stepsize = 0.f;
  std::vector<Precinct> precincts;
  bool empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pdx = 15, pdy = 15;
  int64_t pw = 0, ph = 0;
  std::vector<Band> bands;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;  // Mallat layout, (x1 - x0) wide
  std::vector<float> fdata;
};

int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

int num_passes(BitReader& bio) {  // opj_t2_getnumpasses
  if (!bio.bit()) return 1;
  if (!bio.bit()) return 2;
  uint32_t n = bio.bits(2);
  if (n != 3) return int(3 + n);
  n = bio.bits(5);
  if (n != 31) return int(6 + n);
  return int(37 + bio.bits(7));
}

int comma_code(BitReader& bio) {
  int n = 0;
  while (bio.bit()) {
    ++n;
    if (n > 64) fail("packet header: runaway length increment");
  }
  return n;
}

// Read one packet (header and body) at data[*pos]; the body's code-block
// contributions are appended to the code-blocks
void read_packet(TileComp& tc, int resno, int64_t precno, int layno, const uint8_t* data, size_t len, size_t* pos) {
  Resolution& res = tc.res[resno];
  if (*pos > len) fail("packet past the end of the tile's data");
  BitReader bio(data + *pos, len - *pos);
  struct Contribution {
    CodeBlock* cb;
    uint32_t length;
  };
  std::vector<Contribution> contrib;
  if (bio.bit()) {
    for (Band& band : res.bands) {
      if (band.empty()) continue;
      Precinct& prc = band.precincts[size_t(precno)];
      int n = prc.cw * prc.ch;
      for (int i = 0; i < n; ++i) {
        CodeBlock& cb = prc.blocks[size_t(i)];
        int included = cb.included ? bio.bit() : prc.incl.decode(bio, i, layno + 1);
        if (!included) continue;
        if (!cb.included) {
          int zbp = 0;
          while (!prc.imsb.decode(bio, i, zbp)) {
            ++zbp;
            if (zbp > 64) fail("packet header: runaway zero bit-planes");
          }
          cb.numbps = band.numbps + 1 - zbp;
          cb.lenbits = 3;
          cb.included = true;
        }
        int np = num_passes(bio);
        cb.lenbits += comma_code(bio);
        int bits = cb.lenbits + floorlog2(uint32_t(np));
        if (bits > 32) fail("packet header: a length of %d bits", bits);
        uint32_t length = bio.bits(bits);
        cb.passes += np;
        if (cb.passes > 109) fail("code-block of more than 109 coding passes");
        contrib.push_back({&cb, length});
      }
    }
  }
  bio.inalign();
  if (bio.overran()) fail("packet header past the end of the tile's data");
  size_t at = *pos + bio.consumed();
  for (const Contribution& c : contrib) {
    if (c.length > len - at) fail("code-block data past the end of the tile's data");
    c.cb->data.insert(c.cb->data.end(), data + at, data + at + c.length);
    at += c.length;
  }
  *pos = at;
}

// ------------------------------------------------------------ tier-1

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1C01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02A1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

constexpr int kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17, kCtxUni = 18, kNumCtx = 19;

struct Context {
  uint8_t state, mps;
};

void reset_contexts(Context* ctx) {
  for (int i = 0; i < kNumCtx; ++i) ctx[i] = {0, 0};
  ctx[kCtxUni] = {46, 0};
  ctx[kCtxAgg] = {3, 0};
  ctx[kCtxZc] = {4, 0};
}

class MqDecoder {  // opj_mqc, decoding
 public:
  // `p` holds n bytes of data followed by two writable bytes
  void init(uint8_t* p, size_t n) {
    p[n] = 0xFF;
    p[n + 1] = 0xFF;
    bp_ = p;
    c_ = n == 0 ? 0xFFu << 16 : uint32_t(*bp_) << 16;
    bytein();
    c_ <<= 7;
    ct_ -= 7;
    a_ = 0x8000;
  }
  int decode(Context& cx) {
    const MqState& s = kMq[cx.state];
    uint32_t qe = s.qe;
    int d;
    a_ -= qe;
    if ((c_ >> 16) < qe) {
      if (a_ < qe) {
        a_ = qe;
        d = cx.mps;
        cx.state = s.nmps;
      } else {
        a_ = qe;
        d = 1 - cx.mps;
        if (s.sw) cx.mps = uint8_t(1 - cx.mps);
        cx.state = s.nlps;
      }
      renorm();
    } else {
      c_ -= qe << 16;
      if ((a_ & 0x8000) == 0) {
        if (a_ < qe) {
          d = 1 - cx.mps;
          if (s.sw) cx.mps = uint8_t(1 - cx.mps);
          cx.state = s.nlps;
        } else {
          d = cx.mps;
          cx.state = s.nmps;
        }
        renorm();
      } else {
        d = cx.mps;
      }
    }
    return d;
  }

 private:
  void bytein() {
    if (*bp_ == 0xFF) {
      if (bp_[1] > 0x8F) {
        c_ += 0xFF00;
        ct_ = 8;
      } else {
        ++bp_;
        c_ += uint32_t(*bp_) << 9;
        ct_ = 7;
      }
    } else {
      ++bp_;
      c_ += uint32_t(*bp_) << 8;
      ct_ = 8;
    }
  }
  void renorm() {
    do {
      if (ct_ == 0) bytein();
      a_ <<= 1;
      c_ <<= 1;
      --ct_;
    } while (a_ < 0x8000);
  }
  uint8_t* bp_ = nullptr;
  uint32_t a_ = 0, c_ = 0;
  int ct_ = 0;
};

// Per-sample flags: the significance of the eight neighbours, the signs of
// the four direct ones, and the sample's own state
enum : uint16_t {
  kSigNE = 0x0001, kSigSE = 0x0002, kSigSW = 0x0004, kSigNW = 0x0008,
  kSigN = 0x0010, kSigE = 0x0020, kSigS = 0x0040, kSigW = 0x0080,
  kSigOth = 0x00FF,
  kSgnN = 0x0100, kSgnE = 0x0200, kSgnS = 0x0400, kSgnW = 0x0800,
  kSig = 0x1000, kRefine = 0x2000, kVisit = 0x4000,
};

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256];   // by (sig N E S W, sgn N E S W) >> 4
  uint8_t spb[256];
  Luts() {
    for (int orient = 0; orient < 4; ++orient) {
      for (int f = 0; f < 256; ++f) {
        int h = ((f & kSigW) != 0) + ((f & kSigE) != 0);
        int v = ((f & kSigN) != 0) + ((f & kSigS) != 0);
        int d = ((f & kSigNE) != 0) + ((f & kSigSE) != 0) + ((f & kSigSW) != 0) + ((f & kSigNW) != 0);
        int n = 0;
        if (orient == 1) std::swap(h, v);
        if (orient != 3) {
          if (!h) {
            n = !v ? (!d ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
          } else if (h == 1) {
            n = !v ? (!d ? 5 : 6) : 7;
          } else {
            n = 8;
          }
        } else {
          int hv = h + v;
          if (!d) {
            n = !hv ? 0 : hv == 1 ? 1 : 2;
          } else if (d == 1) {
            n = !hv ? 3 : hv == 1 ? 4 : 5;
          } else if (d == 2) {
            n = !hv ? 6 : 7;
          } else {
            n = 8;
          }
        }
        zc[orient][f] = uint8_t(kCtxZc + n);
      }
    }
    for (int i = 0; i < 256; ++i) {
      int f = i << 4;  // kSigN..kSigW and kSgnN..kSgnW
      auto contrib = [&](uint16_t sig, uint16_t sgn) { return (f & sig) ? ((f & sgn) ? -1 : 1) : 0; };
      int hc = std::clamp(contrib(kSigE, kSgnE) + contrib(kSigW, kSgnW), -1, 1);
      int vc = std::clamp(contrib(kSigN, kSgnN) + contrib(kSigS, kSgnS), -1, 1);
      int ctx, x = 0;
      if (hc == 0) {
        ctx = vc == 0 ? 9 : 10;
        x = vc < 0;
      } else {
        ctx = vc == 0 ? 12 : (vc == hc ? 13 : 11);
        x = hc < 0;
      }
      sc[i] = uint8_t(ctx);
      spb[i] = uint8_t(x);
    }
  }
};

const Luts& luts() {
  static const Luts l;
  return l;
}

class T1 {
 public:
  void decode(CodeBlock& cb, int orient, std::vector<int32_t>& out) {
    w_ = int(cb.x1 - cb.x0);
    h_ = int(cb.y1 - cb.y0);
    stride_ = w_ + 2;
    flags_.assign(size_t(stride_) * (h_ + 2), 0);
    out.assign(size_t(w_) * h_, 0);
    data_ = out.data();
    if (cb.passes == 0) return;
    int bpno_plus_one = cb.numbps;
    if (bpno_plus_one >= 31) fail("code-block of %d bit-planes", bpno_plus_one);
    size_t n = cb.data.size();
    cb.data.resize(n + 2);
    reset_contexts(ctx_);
    mq_.init(cb.data.data(), n);
    zc_ = luts().zc[orient];
    int passtype = 2;
    // openjpeg hands each pass bpno_plus_one as its bit-plane: the sample
    // keeps one bit below the plane, and the last plane decoded is 1
    for (int pass = 0; pass < cb.passes && bpno_plus_one >= 1; ++pass) {
      if (passtype == 0) {
        sigpass(bpno_plus_one);
      } else if (passtype == 1) {
        refpass(bpno_plus_one);
      } else {
        clnpass(bpno_plus_one);
      }
      if (++passtype == 3) {
        passtype = 0;
        --bpno_plus_one;
      }
    }
  }

 private:
  uint16_t* flag(int x, int y) { return &flags_[size_t(y + 1) * stride_ + x + 1]; }

  void update(int x, int y, int neg) {
    uint16_t* f = flag(x, y);
    uint16_t* n = f - stride_;
    uint16_t* s = f + stride_;
    n[-1] |= kSigSE;
    n[0] |= kSigS | (neg ? kSgnS : 0);
    n[1] |= kSigSW;
    f[-1] |= kSigE | (neg ? kSgnE : 0);
    f[0] |= kSig;
    f[1] |= kSigW | (neg ? kSgnW : 0);
    s[-1] |= kSigNE;
    s[0] |= kSigN | (neg ? kSgnN : 0);
    s[1] |= kSigNW;
  }

  void significant(int x, int y, uint16_t f, int32_t oneplushalf) {
    const Luts& l = luts();
    int i = (f >> 4) & 0xFF;
    int v = mq_.decode(ctx_[l.sc[i]]) ^ l.spb[i];
    data_[size_t(y) * w_ + x] = v ? -oneplushalf : oneplushalf;
    update(x, y, v);
  }

  void sigpass(int bpno) {
    int32_t one = int32_t(1) << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x)
        for (int y = k; y < k + 4 && y < h_; ++y) {
          uint16_t* f = flag(x, y);
          if ((*f & kSigOth) && !(*f & (kSig | kVisit))) {
            if (mq_.decode(ctx_[zc_[*f & kSigOth]])) significant(x, y, *f, oneplushalf);
            *f |= kVisit;
          }
        }
  }

  void refpass(int bpno) {
    int32_t poshalf = (int32_t(1) << bpno) >> 1;
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x)
        for (int y = k; y < k + 4 && y < h_; ++y) {
          uint16_t* f = flag(x, y);
          if ((*f & (kSig | kVisit)) == kSig) {
            int ctx = (*f & kRefine) ? kCtxMag + 2 : (*f & kSigOth) ? kCtxMag + 1 : kCtxMag;
            int v = mq_.decode(ctx_[ctx]);
            int32_t& d = data_[size_t(y) * w_ + x];
            d += (v ^ (d < 0)) ? poshalf : -poshalf;
            *f |= kRefine;
          }
        }
  }

  void clnpass(int bpno) {
    int32_t one = int32_t(1) << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4)
      for (int x = 0; x < w_; ++x) {
        int runlen = 0;
        bool agg = false;
        if (k + 3 < h_) {
          agg = true;
          for (int y = k; y < k + 4; ++y)
            if (*flag(x, y) & (kSig | kVisit | kSigOth)) agg = false;
        }
        if (agg) {
          if (!mq_.decode(ctx_[kCtxAgg])) continue;
          runlen = mq_.decode(ctx_[kCtxUni]);
          runlen = (runlen << 1) | mq_.decode(ctx_[kCtxUni]);
        }
        for (int y = k + runlen; y < k + 4 && y < h_; ++y) {
          uint16_t* f = flag(x, y);
          if (agg && y == k + runlen) {
            significant(x, y, *f, oneplushalf);
          } else if (!(*f & (kSig | kVisit))) {
            if (mq_.decode(ctx_[zc_[*f & kSigOth]])) significant(x, y, *f, oneplushalf);
          }
          *f &= uint16_t(~kVisit);
        }
      }
  }

  int w_ = 0, h_ = 0, stride_ = 0;
  std::vector<uint16_t> flags_;
  int32_t* data_ = nullptr;
  Context ctx_[kNumCtx];
  MqDecoder mq_;
  const uint8_t* zc_ = nullptr;
};

// ------------------------------------------------------------ wavelets

// The inverse wavelets work on `n` signals side by side (n columns of the
// layout, or one row): x[j * n + l] is sample j, in grid order, of signal
// l; cas is the parity of the first sample on the grid. Each signal is
// computed exactly as alone.

// The inverse 5/3 in wrapping 32-bit arithmetic, as openjpeg's
void idwt53(int32_t* x, int len, int n, int cas) {
  if (len == 1) {
    if (cas)
      for (int l = 0; l < n; ++l) x[l] /= 2;
    return;
  }
  if (len < 1) return;
  auto at = [&](int j) { return j < 0 ? -j : j >= len ? 2 * (len - 1) - j : j; };
  for (int j = cas; j < len; j += 2) {  // lows: x -= (left + right + 2) >> 2
    int32_t* a = x + size_t(j) * n;
    const int32_t *p = x + size_t(at(j - 1)) * n, *q = x + size_t(at(j + 1)) * n;
    for (int l = 0; l < n; ++l)
      a[l] = int32_t(uint32_t(a[l]) - uint32_t(int32_t(uint32_t(p[l]) + uint32_t(q[l]) + 2u) >> 2));
  }
  for (int j = 1 - cas; j < len; j += 2) {  // highs: x += (left + right) >> 1
    int32_t* a = x + size_t(j) * n;
    const int32_t *p = x + size_t(at(j - 1)) * n, *q = x + size_t(at(j + 1)) * n;
    for (int l = 0; l < n; ++l) a[l] = int32_t(uint32_t(a[l]) + uint32_t(int32_t(uint32_t(p[l]) + uint32_t(q[l])) >> 1));
  }
}

constexpr float kK = 1.230174105f;
constexpr float kTwoInvK = 1.625732422f;
// the four lifting steps' factors (F.3.8.2: -delta, -gamma, -beta, -alpha)
constexpr float kDelta = -0.443506852f, kGamma = -0.882911075f, kBeta = 0.052980118f, kAlpha = 1.586134342f;

// opj_v8dwt_decode_step2: each sample of parity `p` gains c times the sum
// of its two neighbours; at the left edge (w + w) * c, at the right edge
// l * (c + c)
void lift(float* x, int len, int n, int p, float c) {
  for (int j = p; j < len; j += 2) {
    float* a = x + size_t(j) * n;
    if (j > 0 && j + 1 < len) {
      const float *l = a - n, *r = a + n;
      for (int k = 0; k < n; ++k) a[k] = a[k] + ((l[k] + r[k]) * c);
    } else if (j + 1 < len) {
      const float* r = a + n;
      for (int k = 0; k < n; ++k) a[k] = a[k] + ((r[k] + r[k]) * c);
    } else {
      const float* l = a - n;
      const float c2 = c + c;
      for (int k = 0; k < n; ++k) a[k] = a[k] + (l[k] * c2);
    }
  }
}

// The inverse 9/7 in float32, in openjpeg's order of operations: lows
// times K, highs times 2/K, then the four lifting steps
void idwt97(float* x, int len, int n, int cas) {
  int sn = cas ? len / 2 : (len + 1) / 2, dn = len - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  int lo = cas, hi = 1 - cas;
  for (int j = lo; j < len; j += 2)
    for (int k = 0; k < n; ++k) x[size_t(j) * n + k] = x[size_t(j) * n + k] * kK;
  for (int j = hi; j < len; j += 2)
    for (int k = 0; k < n; ++k) x[size_t(j) * n + k] = x[size_t(j) * n + k] * kTwoInvK;
  lift(x, len, n, lo, kDelta);
  lift(x, len, n, hi, kGamma);
  lift(x, len, n, lo, kBeta);
  lift(x, len, n, hi, kAlpha);
}

// Rows then columns at each level, as openjpeg's decoder; the columns in
// groups of kLanes
template <typename T>
void idwt_2d(TileComp& tc, T* data, void (*one_d)(T*, int, int, int)) {
  constexpr int kLanes = 16;
  size_t w = size_t(tc.x1 - tc.x0);
  std::vector<T> tmp;
  for (size_t r = 1; r < tc.res.size(); ++r) {
    const Resolution& lo = tc.res[r - 1];
    const Resolution& hi = tc.res[r];
    int rw = int(hi.x1 - hi.x0), rh = int(hi.y1 - hi.y0);
    int sw = int(lo.x1 - lo.x0), sh = int(lo.y1 - lo.y0);
    int casx = int(hi.x0 & 1), casy = int(hi.y0 & 1);
    tmp.resize(size_t(std::max(rw, rh)) * kLanes);
    T* x = tmp.data();
    for (int y = 0; y < rh; ++y) {
      T* row = data + size_t(y) * w;
      for (int i = 0; i < sw; ++i) x[casx + 2 * i] = row[i];
      for (int i = 0; i < rw - sw; ++i) x[1 - casx + 2 * i] = row[sw + i];
      one_d(x, rw, 1, casx);
      std::copy(x, x + rw, row);
    }
    for (int c0 = 0; c0 < rw; c0 += kLanes) {
      int n = std::min(kLanes, rw - c0);
      for (int i = 0; i < sh; ++i) std::copy_n(data + size_t(i) * w + c0, n, x + size_t(casy + 2 * i) * n);
      for (int i = 0; i < rh - sh; ++i) std::copy_n(data + size_t(sh + i) * w + c0, n, x + size_t(1 - casy + 2 * i) * n);
      one_d(x, rh, n, casy);
      for (int j = 0; j < rh; ++j) std::copy_n(x + size_t(j) * n, n, data + size_t(j) * w + c0);
    }
  }
}

// ------------------------------------------------------------ tiles

struct TilePart {
  size_t start, end;  // the tile-part's data, after SOD
};

struct Tile {
  std::vector<TilePart> parts;
  int tnsot = 0;
  bool seen = false;
  TileParams params;
};

struct Codestream {
  Image im;
  TileParams main;
  std::vector<Tile> tiles;
};

void init_tile_params(TileParams& tp, int nc) {
  tp.cs.assign(size_t(nc), CodingStyle{});
  tp.q.assign(size_t(nc), Quant{});
  tp.coc.assign(size_t(nc), false);
  tp.qcc.assign(size_t(nc), false);
}

// Marker segments that set nothing: COM, TLM, PLM, PLT, CRG. They are
// checked as openjpeg checks them, and skipped.
bool is_skipped_marker(int m) { return m == 0xFF64 || m == 0xFF55 || m == 0xFF57 || m == 0xFF58 || m == 0xFF63; }

void check_skipped_marker(const Bytes& b, int m, size_t at, int len, int nc) {
  int avail = len - 2;
  size_t p = at + 2;
  switch (m) {
    case 0xFF55: {  // TLM: Ztlm, Stlm, then (Ttlm, Ptlm) pairs
      if (avail < 2) fail("TLM marker segment too short");
      int stlm = b.u8(p + 1);
      int st = (stlm >> 4) & 3, sp = (stlm >> 6) & 1;
      if (st == 3) fail("TLM: ST = 3");
      int entry = st + (sp ? 4 : 2);
      if ((avail - 2) % entry) fail("TLM marker segment of %d bytes", len);
      break;
    }
    case 0xFF57:  // PLM
      if (avail < 1) fail("PLM marker segment too short");
      break;
    case 0xFF58: {  // PLT: Zplt, then packet lengths 7 bits a byte
      if (avail < 1) fail("PLT marker segment too short");
      int pending = 0;
      for (int i = 1; i < avail; ++i) pending = b.u8(p + size_t(i)) & 0x80;
      if (pending) fail("PLT: a packet length cut short");
      break;
    }
    case 0xFF63:  // CRG
      if (avail != 4 * nc) fail("CRG marker segment of %d bytes", len);
      break;
    default:  // COM
      break;
  }
}

Codestream parse(const Bytes& b) {
  Codestream cs;
  if (b.size() < 4 || b.u16(0) != 0xFF4F) fail("no SOC marker");
  if (b.u16(2) != 0xFF51) fail("no SIZ marker after SOC");
  size_t p = 4;
  int len = b.u16(p);
  read_siz(b, p + 2, len - 2, cs.im);
  p += size_t(len);
  int nc = int(cs.im.comps.size());
  init_tile_params(cs.main, nc);
  // the main header
  while (true) {
    int m = b.u16(p);
    if (m == 0xFF90) break;
    if (m < 0xFF30) fail("no marker where one was expected (0x%04x)", m);
    len = b.u16(p + 2);
    if (len < 2) fail("marker segment 0x%04x of length %d", m, len);
    if (p + 2 + size_t(len) > b.size()) fail("marker segment 0x%04x past the end of the data", m);
    if (is_param_marker(m)) {
      read_param_marker(b, m, p + 2, len, cs.im, cs.main);
    } else if (is_skipped_marker(m) && m != 0xFF58) {
      check_skipped_marker(b, m, p + 2, len, nc);
    } else {
      refuse_marker(m);
    }
    p += 2 + size_t(len);
  }
  if (!cs.main.cod) fail("no COD marker in the main header");
  if (!cs.main.qcd) fail("no QCD marker in the main header");
  cs.tiles.resize(size_t(cs.im.ntx * cs.im.nty));
  // the tile-parts
  while (true) {
    int m = b.u16(p);
    if (m == 0xFFD9) break;
    if (m != 0xFF90) fail("no SOT or EOC marker where one was expected (0x%04x)", m);
    size_t sot = p;
    if (b.u16(p + 2) != 10) fail("SOT marker segment of length %d", b.u16(p + 2));
    int isot = b.u16(p + 4);
    uint32_t psot = b.u32(p + 6);
    int tpsot = b.u8(p + 10), tnsot = b.u8(p + 11);
    if (size_t(isot) >= cs.tiles.size()) fail("tile-part of tile %d of %zu", isot, cs.tiles.size());
    Tile& t = cs.tiles[size_t(isot)];
    if (tpsot != int(t.parts.size())) fail("tile %d: tile-part %d after %zu tile-parts", isot, tpsot, t.parts.size());
    if (tnsot) {
      if ((t.tnsot && tnsot != t.tnsot) || tpsot >= tnsot) fail("tile %d: tile-part %d of %d", isot, tpsot, tnsot);
      t.tnsot = tnsot;
    }
    if (psot != 0 && psot < 14) fail("SOT: tile-part length %u", psot);
    size_t end = psot == 0 ? (b.size() >= 2 ? b.size() - 2 : 0) : sot + psot;
    if (end > b.size() || end < sot + 14) fail("tile-part past the end of the data");
    if (!t.seen) {
      t.params = cs.main;
      t.params.cod = t.params.qcd = false;
      t.params.coc.assign(size_t(nc), false);
      t.params.qcc.assign(size_t(nc), false);
    }
    p += 12;
    while (true) {
      m = b.u16(p);
      if (m == 0xFF93) break;
      if (m < 0xFF30) fail("no marker where one was expected (0x%04x)", m);
      len = b.u16(p + 2);
      if (len < 2) fail("marker segment 0x%04x of length %d", m, len);
      if (p + 2 + size_t(len) > end) fail("marker segment 0x%04x past the end of its tile-part", m);
      if (is_param_marker(m)) {
        if (t.seen) fail("marker 0x%04x in a tile-part other than the first", m);
        read_param_marker(b, m, p + 2, len, cs.im, t.params);
      } else if (m == 0xFF64 || m == 0xFF58) {  // COM, PLT
        check_skipped_marker(b, m, p + 2, len, nc);
      } else {
        refuse_marker(m);
      }
      p += 2 + size_t(len);
    }
    t.seen = true;
    if (p + 2 > end) fail("SOD past the end of its tile-part");
    t.parts.push_back({p + 2, end});
    p = end;
    if (psot == 0) {
      if (b.u16(p) != 0xFFD9) fail("no EOC after a tile-part that runs to the end");
      break;
    }
  }
  for (size_t i = 0; i < cs.tiles.size(); ++i) {
    const Tile& t = cs.tiles[i];
    if (!t.seen) fail("tile %zu has no tile-part", i);
    if (t.tnsot && int(t.parts.size()) != t.tnsot) fail("tile %zu: %zu of %d tile-parts", i, t.parts.size(), t.tnsot);
  }
  return cs;
}

// The geometry of one tile-component (B.5-B.7), its precincts and
// code-blocks
void build_tilecomp(const Comp& comp, const CodingStyle& cs, const Quant& q, int64_t tx0, int64_t ty0,
                    int64_t tx1, int64_t ty1, TileComp& tc) {
  tc.x0 = ceildiv(tx0, comp.dx);
  tc.y0 = ceildiv(ty0, comp.dy);
  tc.x1 = ceildiv(tx1, comp.dx);
  tc.y1 = ceildiv(ty1, comp.dy);
  int nres = cs.nres;
  int nl = nres - 1;
  int needed = q.qntsty == 0 || q.qntsty == 2 ? 3 * nl + 1 : 1;
  if (q.nbands < needed) fail("QCD/QCC gives %d bands for %d", q.nbands, needed);
  tc.res.assign(size_t(nres), Resolution{});
  for (int r = 0; r < nres; ++r) {
    Resolution& res = tc.res[size_t(r)];
    int lev = nl - r;
    res.x0 = ceildivpow2(tc.x0, lev);
    res.y0 = ceildivpow2(tc.y0, lev);
    res.x1 = ceildivpow2(tc.x1, lev);
    res.y1 = ceildivpow2(tc.y1, lev);
    res.pdx = cs.prcw[r];
    res.pdy = cs.prch[r];
    int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx, py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
    int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx, py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
    res.pw = res.x0 == res.x1 ? 0 : (px1 - px0) >> res.pdx;
    res.ph = res.y0 == res.y1 ? 0 : (py1 - py0) >> res.pdy;
    if (res.pw * res.ph > (int64_t(1) << 26)) fail("%lld precincts in a resolution", (long long)(res.pw * res.ph));
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = px0;
      cbgy0 = py0;
      cbgw = res.pdx;
      cbgh = res.pdy;
    } else {
      cbgx0 = ceildivpow2(px0, 1);
      cbgy0 = ceildivpow2(py0, 1);
      cbgw = res.pdx - 1;
      cbgh = res.pdy - 1;
    }
    int cbw = std::min(cs.cbw, cbgw), cbh = std::min(cs.cbh, cbgh);
    int nb = r == 0 ? 1 : 3;
    res.bands.assign(size_t(nb), Band{});
    for (int bi = 0; bi < nb; ++bi) {
      Band& band = res.bands[size_t(bi)];
      band.orient = r == 0 ? 0 : bi + 1;
      int xo = band.orient & 1, yo = band.orient >> 1;
      int nbl = r == 0 ? nl : nl - r + 1;
      if (r == 0) {
        band.x0 = ceildivpow2(tc.x0, nbl);
        band.y0 = ceildivpow2(tc.y0, nbl);
        band.x1 = ceildivpow2(tc.x1, nbl);
        band.y1 = ceildivpow2(tc.y1, nbl);
      } else {
        int64_t ox = int64_t(xo) << (nbl - 1), oy = int64_t(yo) << (nbl - 1);
        band.x0 = ceildivpow2(tc.x0 - ox, nbl);
        band.y0 = ceildivpow2(tc.y0 - oy, nbl);
        band.x1 = ceildivpow2(tc.x1 - ox, nbl);
        band.y1 = ceildivpow2(tc.y1 - oy, nbl);
      }
      int bandno = r == 0 ? 0 : 3 * (r - 1) + bi + 1;
      int expn = q.expn[bandno], mant = q.mant[bandno];
      band.numbps = expn + q.guard - 1;
      // every band at gain 0: the 2/K on the high-pass samples makes up for it
      band.stepsize = float((1.0 + mant / 2048.0) * std::pow(2.0, double(comp.prec - expn)));
      if (band.empty()) continue;
      band.precincts.assign(size_t(res.pw * res.ph), Precinct{});
      for (int64_t pi = 0; pi < res.pw * res.ph; ++pi) {
        Precinct& prc = band.precincts[size_t(pi)];
        int64_t gx0 = cbgx0 + (pi % res.pw) * (int64_t(1) << cbgw);
        int64_t gy0 = cbgy0 + (pi / res.pw) * (int64_t(1) << cbgh);
        int64_t x0 = std::max(gx0, band.x0), y0 = std::max(gy0, band.y0);
        int64_t x1 = std::min(gx0 + (int64_t(1) << cbgw), band.x1), y1 = std::min(gy0 + (int64_t(1) << cbgh), band.y1);
        if (x0 >= x1 || y0 >= y1) continue;
        int64_t bx0 = floordivpow2(x0, cbw) << cbw, by0 = floordivpow2(y0, cbh) << cbh;
        int64_t bx1 = ceildivpow2(x1, cbw) << cbw, by1 = ceildivpow2(y1, cbh) << cbh;
        prc.cw = int((bx1 - bx0) >> cbw);
        prc.ch = int((by1 - by0) >> cbh);
        prc.blocks.resize(size_t(prc.cw) * prc.ch);
        for (int i = 0; i < prc.cw * prc.ch; ++i) {
          CodeBlock& cb = prc.blocks[size_t(i)];
          int64_t cx = bx0 + int64_t(i % prc.cw) * (int64_t(1) << cbw);
          int64_t cy = by0 + int64_t(i / prc.cw) * (int64_t(1) << cbh);
          cb.x0 = std::max(cx, x0);
          cb.y0 = std::max(cy, y0);
          cb.x1 = std::min(cx + (int64_t(1) << cbw), x1);
          cb.y1 = std::min(cy + (int64_t(1) << cbh), y1);
        }
        prc.incl.init(prc.cw, prc.ch);
        prc.imsb.init(prc.cw, prc.ch);
      }
    }
  }
}

// openjpeg's packet iterator (pi.c) for one tile, without POC: calls
// visit(compno, resno, precno, layno) for each packet in order
struct PacketOrder {
  const Image& im;
  std::vector<TileComp>& tcs;
  const TileParams& tp;
  int64_t tx0, ty0, tx1, ty1;

  template <typename V>
  void run(V visit) {
    int nc = int(tcs.size());
    int maxres = 0;
    int64_t maxprec = 0;
    for (auto& tc : tcs) {
      maxres = std::max(maxres, int(tc.res.size()));
      for (auto& r : tc.res) maxprec = std::max(maxprec, r.pw * r.ph);
    }
    int layers = tp.layers;
    int64_t step_p = 1, step_c = maxprec * step_p, step_r = nc * step_c, step_l = maxres * step_r;
    if (layers * step_l > (int64_t(1) << 28)) fail("%lld packets in a tile", (long long)(layers * step_l));
    std::vector<uint8_t> include(size_t(layers * step_l), 0);
    auto emit = [&](int c, int r, int64_t p, int l) {
      size_t idx = size_t(l * step_l + r * step_r + c * step_c + p * step_p);
      if (include[idx]) return;
      include[idx] = 1;
      visit(c, r, p, l);
    };
    auto precinct_at = [&](int c, int r, int64_t x, int64_t y, int64_t* precno) -> bool {
      const TileComp& tc = tcs[size_t(c)];
      const Resolution& res = tc.res[size_t(r)];
      const Comp& comp = im.comps[size_t(c)];
      int levelno = int(tc.res.size()) - 1 - r;
      int64_t trx0 = ceildiv(tx0, int64_t(comp.dx) << levelno), try0 = ceildiv(ty0, int64_t(comp.dy) << levelno);
      int64_t trx1 = ceildiv(tx1, int64_t(comp.dx) << levelno), try1 = ceildiv(ty1, int64_t(comp.dy) << levelno);
      int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
      if (rpx >= 31 || rpy >= 31) return false;
      if (!(y % (int64_t(comp.dy) << rpy) == 0 || (y == ty0 && ((try0 << levelno) % (int64_t(1) << rpy))))) return false;
      if (!(x % (int64_t(comp.dx) << rpx) == 0 || (x == tx0 && ((trx0 << levelno) % (int64_t(1) << rpx))))) return false;
      if (res.pw == 0 || res.ph == 0) return false;
      if (trx0 == trx1 || try0 == try1) return false;
      int64_t prci = floordivpow2(ceildiv(x, int64_t(comp.dx) << levelno), res.pdx) - floordivpow2(trx0, res.pdx);
      int64_t prcj = floordivpow2(ceildiv(y, int64_t(comp.dy) << levelno), res.pdy) - floordivpow2(try0, res.pdy);
      *precno = prci + prcj * res.pw;
      return true;
    };
    auto steps = [&](int c0, int c1, int64_t* dx, int64_t* dy) {
      *dx = *dy = 0;
      for (int c = c0; c < c1; ++c) {
        const TileComp& tc = tcs[size_t(c)];
        const Comp& comp = im.comps[size_t(c)];
        int nr = int(tc.res.size());
        for (int r = 0; r < nr; ++r) {
          const Resolution& res = tc.res[size_t(r)];
          int ex = res.pdx + nr - 1 - r, ey = res.pdy + nr - 1 - r;
          if (ex < 32) {
            int64_t d = int64_t(comp.dx) << ex;
            *dx = *dx ? std::min(*dx, d) : d;
          }
          if (ey < 32) {
            int64_t d = int64_t(comp.dy) << ey;
            *dy = *dy ? std::min(*dy, d) : d;
          }
        }
      }
      if (*dx == 0 || *dy == 0) fail("packet iterator without a step");
    };
    switch (tp.prog) {
      case 0:  // LRCP
        for (int l = 0; l < layers; ++l)
          for (int r = 0; r < maxres; ++r)
            for (int c = 0; c < nc; ++c) {
              if (r >= int(tcs[size_t(c)].res.size())) continue;
              const Resolution& res = tcs[size_t(c)].res[size_t(r)];
              for (int64_t p = 0; p < res.pw * res.ph; ++p) emit(c, r, p, l);
            }
        break;
      case 1:  // RLCP
        for (int r = 0; r < maxres; ++r)
          for (int l = 0; l < layers; ++l)
            for (int c = 0; c < nc; ++c) {
              if (r >= int(tcs[size_t(c)].res.size())) continue;
              const Resolution& res = tcs[size_t(c)].res[size_t(r)];
              for (int64_t p = 0; p < res.pw * res.ph; ++p) emit(c, r, p, l);
            }
        break;
      case 2: {  // RPCL
        int64_t dx, dy;
        steps(0, nc, &dx, &dy);
        for (int r = 0; r < maxres; ++r)
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int c = 0; c < nc; ++c) {
                if (r >= int(tcs[size_t(c)].res.size())) continue;
                int64_t p;
                if (!precinct_at(c, r, x, y, &p)) continue;
                for (int l = 0; l < layers; ++l) emit(c, r, p, l);
              }
        break;
      }
      case 3: {  // PCRL
        int64_t dx, dy;
        steps(0, nc, &dx, &dy);
        for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
          for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
            for (int c = 0; c < nc; ++c)
              for (int r = 0; r < int(tcs[size_t(c)].res.size()); ++r) {
                int64_t p;
                if (!precinct_at(c, r, x, y, &p)) continue;
                for (int l = 0; l < layers; ++l) emit(c, r, p, l);
              }
        break;
      }
      case 4: {  // CPRL
        for (int c = 0; c < nc; ++c) {
          int64_t dx, dy;
          steps(c, c + 1, &dx, &dy);
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int r = 0; r < int(tcs[size_t(c)].res.size()); ++r) {
                int64_t p;
                if (!precinct_at(c, r, x, y, &p)) continue;
                for (int l = 0; l < layers; ++l) emit(c, r, p, l);
              }
        }
        break;
      }
    }
  }
};

// Tier-1 of every code-block of a tile-component into its Mallat layout
void decode_blocks(TileComp& tc, int qmfbid) {
  size_t w = size_t(tc.x1 - tc.x0), h = size_t(tc.y1 - tc.y0);
  if (qmfbid == 1) {
    tc.idata.assign(w * h, 0);
  } else {
    tc.fdata.assign(w * h, 0.f);
  }
  struct Job {
    CodeBlock* cb;
    const Band* band;
    int64_t ox, oy;  // the band's origin in the layout
  };
  std::vector<Job> jobs;
  for (size_t r = 0; r < tc.res.size(); ++r) {
    for (Band& band : tc.res[r].bands) {
      if (band.empty()) continue;
      int64_t ox = 0, oy = 0;
      if (band.orient & 1) ox = tc.res[r - 1].x1 - tc.res[r - 1].x0;
      if (band.orient & 2) oy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
      for (Precinct& prc : band.precincts)
        for (CodeBlock& cb : prc.blocks)
          if (cb.included) jobs.push_back({&cb, &band, ox, oy});
    }
  }
  T1 t1;
  std::vector<int32_t> out;
  for (const Job& job : jobs) {
    CodeBlock& cb = *job.cb;
    t1.decode(cb, job.band->orient, out);
    size_t cw = size_t(cb.x1 - cb.x0), ch = size_t(cb.y1 - cb.y0);
    size_t x0 = size_t(cb.x0 - job.band->x0 + job.ox), y0 = size_t(cb.y0 - job.band->y0 + job.oy);
    if (qmfbid == 1) {
      for (size_t y = 0; y < ch; ++y)
        for (size_t x = 0; x < cw; ++x) tc.idata[(y0 + y) * w + x0 + x] = out[y * cw + x] / 2;
    } else {
      const float step = 0.5f * job.band->stepsize;
      for (size_t y = 0; y < ch; ++y)
        for (size_t x = 0; x < cw; ++x) tc.fdata[(y0 + y) * w + x0 + x] = float(out[y * cw + x]) * step;
    }
    std::vector<uint8_t>().swap(cb.data);
  }
}

void decode_tile(const Bytes& b, Codestream& cs, size_t tileno, int32_t* out) {
  const Image& im = cs.im;
  Tile& tile = cs.tiles[tileno];
  const TileParams& tp = tile.params;
  int nc = int(im.comps.size());
  int64_t p = int64_t(tileno) % im.ntx, q = int64_t(tileno) / im.ntx;
  int64_t tx0 = std::max(im.tx0 + p * im.tw, im.x0), ty0 = std::max(im.ty0 + q * im.th, im.y0);
  int64_t tx1 = std::min(im.tx0 + (p + 1) * im.tw, im.x1), ty1 = std::min(im.ty0 + (q + 1) * im.th, im.y1);
  std::vector<TileComp> tcs(static_cast<size_t>(nc));
  for (int c = 0; c < nc; ++c)
    build_tilecomp(im.comps[size_t(c)], tp.cs[size_t(c)], tp.q[size_t(c)], tx0, ty0, tx1, ty1, tcs[size_t(c)]);
  // the tile's data: its tile-parts one after another
  std::vector<uint8_t> data;
  for (const TilePart& part : tile.parts) data.insert(data.end(), b.ptr(part.start), b.ptr(part.end));
  size_t pos = 0;
  PacketOrder order{im, tcs, tp, tx0, ty0, tx1, ty1};
  order.run([&](int c, int r, int64_t precno, int l) {
    read_packet(tcs[size_t(c)], r, precno, l, data.data(), data.size(), &pos);
  });
  std::vector<uint8_t>().swap(data);
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = tcs[size_t(c)];
    int qmf = tp.cs[size_t(c)].qmfbid;
    decode_blocks(tc, qmf);
    if (qmf == 1) {
      idwt_2d<int32_t>(tc, tc.idata.data(), idwt53);
    } else {
      idwt_2d<float>(tc, tc.fdata.data(), idwt97);
    }
  }
  size_t n = size_t(tx1 - tx0) * size_t(ty1 - ty0);
  if (tp.mct == 1 && nc >= 3) {
    int q0 = tp.cs[0].qmfbid;
    if (tp.cs[1].qmfbid != q0 || tp.cs[2].qmfbid != q0) unsupported("component transform over mixed wavelets");
    if (q0 == 1) {
      int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
      for (size_t i = 0; i < n; ++i) {
        uint32_t y = uint32_t(c0[i]), u = uint32_t(c1[i]), v = uint32_t(c2[i]);
        uint32_t g = y - uint32_t(int32_t(u + v) >> 2);
        c0[i] = int32_t(v + g);
        c1[i] = int32_t(g);
        c2[i] = int32_t(u + g);
      }
    } else {
      float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
      for (size_t i = 0; i < n; ++i) {
        float y = c0[i], u = c1[i], v = c2[i];
        c0[i] = y + (v * 1.402f);
        c1[i] = y - (u * 0.34413f) - (v * 0.71414f);
        c2[i] = y + (u * 1.772f);
      }
    }
  }
  int64_t W = im.x1 - im.x0, H = im.y1 - im.y0;
  size_t tw = size_t(tx1 - tx0);
  for (int c = 0; c < nc; ++c) {
    const Comp& comp = im.comps[size_t(c)];
    const TileComp& tc = tcs[size_t(c)];
    int64_t lo = comp.sgnd ? -(int64_t(1) << (comp.prec - 1)) : 0;
    int64_t hi = comp.sgnd ? (int64_t(1) << (comp.prec - 1)) - 1 : (int64_t(1) << comp.prec) - 1;
    int32_t shift = comp.sgnd ? 0 : int32_t(1) << (comp.prec - 1);
    int32_t* plane = out + size_t(c) * size_t(W) * size_t(H);
    for (int64_t y = ty0; y < ty1; ++y) {
      int32_t* row = plane + size_t(y - im.y0) * size_t(W) + size_t(tx0 - im.x0);
      size_t base = size_t(y - ty0) * tw;
      if (tp.cs[size_t(c)].qmfbid == 1) {
        for (size_t x = 0; x < tw; ++x) {
          int64_t v = int32_t(uint32_t(tc.idata[base + x]) + uint32_t(shift));
          row[x] = int32_t(std::clamp(v, lo, hi));
        }
      } else {
        for (size_t x = 0; x < tw; ++x) {
          float v = tc.fdata[base + x];
          if (v > float(INT32_MAX)) {
            row[x] = int32_t(hi);
          } else if (v < float(INT32_MIN)) {
            row[x] = int32_t(lo);
          } else {
            int64_t r = int64_t(lrintf(v)) + shift;
            row[x] = int32_t(std::clamp(r, lo, hi));
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ the encoder

class MqEncoder {  // Annex C's encoder, as opj_mqc's
 public:
  MqEncoder() { buf_.assign(1, 0); }
  void encode(Context& cx, int d) {
    const MqState& s = kMq[cx.state];
    uint32_t qe = s.qe;
    if (d == cx.mps) {
      a_ -= qe;
      if ((a_ & 0x8000) == 0) {
        if (a_ < qe) {
          a_ = qe;
        } else {
          c_ += qe;
        }
        cx.state = s.nmps;
        renorm();
      } else {
        c_ += qe;
      }
    } else {
      a_ -= qe;
      if (a_ < qe) {
        c_ += qe;
      } else {
        a_ = qe;
      }
      if (s.sw) cx.mps = uint8_t(1 - cx.mps);
      cx.state = s.nlps;
      renorm();
    }
  }
  // The terminated bytes (without the dummy byte before them)
  std::vector<uint8_t> flush() {
    uint32_t tempc = c_ + a_;
    c_ |= 0xFFFF;
    if (c_ >= tempc) c_ -= 0x8000;
    c_ <<= ct_;
    byteout();
    c_ <<= ct_;
    byteout();
    size_t n = buf_.size();
    if (buf_.back() == 0xFF) --n;  // a pass may not end with 0xFF
    return std::vector<uint8_t>(buf_.begin() + 1, buf_.begin() + long(n));
  }

 private:
  void renorm() {
    do {
      a_ <<= 1;
      c_ <<= 1;
      if (--ct_ == 0) byteout();
    } while ((a_ & 0x8000) == 0);
  }
  void byteout() {
    uint8_t& b = buf_.back();
    if (b == 0xFF) {
      buf_.push_back(uint8_t(c_ >> 20));
      c_ &= 0xFFFFF;
      ct_ = 7;
    } else if ((c_ & 0x8000000) == 0) {
      buf_.push_back(uint8_t(c_ >> 19));
      c_ &= 0x7FFFF;
      ct_ = 8;
    } else {
      ++b;
      if (b == 0xFF) {
        c_ &= 0x7FFFFFF;
        buf_.push_back(uint8_t(c_ >> 20));
        c_ &= 0xFFFFF;
        ct_ = 7;
      } else {
        buf_.push_back(uint8_t(c_ >> 19));
        c_ &= 0x7FFFF;
        ct_ = 8;
      }
    }
  }
  std::vector<uint8_t> buf_;
  uint32_t a_ = 0x8000, c_ = 0;
  int ct_ = 12;
};

// Tier-1 encoding of one code-block: all passes, one terminated segment.
// Returns the number of magnitude bit-planes (0 for an all-zero block).
int encode_block(const int32_t* coef, size_t stride, int w, int h, int orient, std::vector<uint8_t>& bytes,
                 int* passes) {
  int32_t maxmag = 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) maxmag = std::max(maxmag, std::abs(coef[size_t(y) * stride + x]));
  int nbp = 0;
  while (nbp < 31 && (maxmag >> nbp)) ++nbp;
  bytes.clear();
  *passes = 0;
  if (nbp == 0) return 0;
  const Luts& l = luts();
  int fs = w + 2;
  std::vector<uint16_t> flags(size_t(fs) * (h + 2), 0);
  auto flag = [&](int x, int y) { return &flags[size_t(y + 1) * fs + x + 1]; };
  auto mag = [&](int x, int y) { return std::abs(coef[size_t(y) * stride + x]); };
  auto neg = [&](int x, int y) { return coef[size_t(y) * stride + x] < 0 ? 1 : 0; };
  Context ctx[kNumCtx];
  reset_contexts(ctx);
  MqEncoder mq;
  const uint8_t* zc = l.zc[orient];
  auto update = [&](int x, int y, int ng) {
    uint16_t* f = flag(x, y);
    uint16_t* n = f - fs;
    uint16_t* s = f + fs;
    n[-1] |= kSigSE;
    n[0] |= kSigS | (ng ? kSgnS : 0);
    n[1] |= kSigSW;
    f[-1] |= kSigE | (ng ? kSgnE : 0);
    f[0] |= kSig;
    f[1] |= kSigW | (ng ? kSgnW : 0);
    s[-1] |= kSigNE;
    s[0] |= kSigN | (ng ? kSgnN : 0);
    s[1] |= kSigNW;
  };
  auto sign = [&](int x, int y) {
    uint16_t f = *flag(x, y);
    int i = (f >> 4) & 0xFF;
    int ng = neg(x, y);
    mq.encode(ctx[l.sc[i]], ng ^ l.spb[i]);
    update(x, y, ng);
  };
  for (int bp = nbp - 1; bp >= 0; --bp) {
    if (bp != nbp - 1) {
      // significance propagation
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; ++x)
          for (int y = k; y < k + 4 && y < h; ++y) {
            uint16_t* f = flag(x, y);
            if ((*f & kSigOth) && !(*f & (kSig | kVisit))) {
              int bit = (mag(x, y) >> bp) & 1;
              mq.encode(ctx[zc[*f & kSigOth]], bit);
              if (bit) sign(x, y);
              *f |= kVisit;
            }
          }
      // magnitude refinement
      for (int k = 0; k < h; k += 4)
        for (int x = 0; x < w; ++x)
          for (int y = k; y < k + 4 && y < h; ++y) {
            uint16_t* f = flag(x, y);
            if ((*f & (kSig | kVisit)) == kSig) {
              int c = (*f & kRefine) ? kCtxMag + 2 : (*f & kSigOth) ? kCtxMag + 1 : kCtxMag;
              mq.encode(ctx[c], (mag(x, y) >> bp) & 1);
              *f |= kRefine;
            }
          }
      *passes += 2;
    }
    // clean-up
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        bool agg = false;
        int runlen = 0;
        if (k + 3 < h) {
          agg = true;
          for (int y = k; y < k + 4; ++y)
            if (*flag(x, y) & (kSig | kVisit | kSigOth)) agg = false;
        }
        if (agg) {
          while (runlen < 4 && !((mag(x, k + runlen) >> bp) & 1)) ++runlen;
          mq.encode(ctx[kCtxAgg], runlen < 4);
          if (runlen == 4) continue;
          mq.encode(ctx[kCtxUni], runlen >> 1);
          mq.encode(ctx[kCtxUni], runlen & 1);
        }
        for (int y = k + runlen; y < k + 4 && y < h; ++y) {
          uint16_t* f = flag(x, y);
          if (agg && y == k + runlen) {
            sign(x, y);
          } else if (!(*f & (kSig | kVisit))) {
            int bit = (mag(x, y) >> bp) & 1;
            mq.encode(ctx[zc[*f & kSigOth]], bit);
            if (bit) sign(x, y);
          }
          *f &= uint16_t(~kVisit);
        }
      }
    *passes += 1;
  }
  bytes = mq.flush();
  return nbp;
}

class BitWriter {  // opj_bio, encoding: a 0 bit stuffed after each 0xFF
 public:
  void bit(int b) {
    if (ct_ == 0) byteout();
    --ct_;
    buf_ |= uint32_t(b & 1) << ct_;
  }
  void bits(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) bit(int((v >> i) & 1));
  }
  std::vector<uint8_t> finish() {
    byteout();
    if (ct_ == 7) byteout();
    return out_;
  }

 private:
  void byteout() {
    buf_ = (buf_ << 8) & 0xFFFF;
    ct_ = buf_ == 0xFF00 ? 7 : 8;
    out_.push_back(uint8_t(buf_ >> 8));
  }
  std::vector<uint8_t> out_;
  uint32_t buf_ = 0;
  int ct_ = 8;
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

void put32(std::vector<uint8_t>& o, uint32_t v) {
  put16(o, int(v >> 16));
  put16(o, int(v & 0xFFFF));
}

void fdwt53_1d(int32_t* a, size_t stride, int len, std::vector<int32_t>& tmp) {
  if (len < 2) return;
  tmp.resize(size_t(len));
  int32_t* x = tmp.data();
  for (int j = 0; j < len; ++j) x[j] = a[size_t(j) * stride];
  auto at = [&](int j) { return x[j < 0 ? -j : j >= len ? 2 * (len - 1) - j : j]; };
  for (int j = 1; j < len; j += 2) x[j] -= (at(j - 1) + at(j + 1)) >> 1;
  for (int j = 0; j < len; j += 2) x[j] += (at(j - 1) + at(j + 1) + 2) >> 2;
  int sn = (len + 1) / 2;
  for (int i = 0; i < sn; ++i) a[size_t(i) * stride] = x[2 * i];
  for (int i = 0; i < len / 2; ++i) a[size_t(sn + i) * stride] = x[2 * i + 1];
}

std::vector<uint8_t> encode(const int32_t* planes, int w, int h, int nc, int prec) {
  int nl = 0;
  while (nl < 5 && (w >> (nl + 1)) > 0 && (h >> (nl + 1)) > 0) ++nl;
  constexpr int kCb = 6;  // 64 x 64 code-blocks, one to a precinct
  std::vector<uint8_t> o;
  put16(o, 0xFF4F);
  put16(o, 0xFF51);  // SIZ
  put16(o, 38 + 3 * nc);
  put16(o, 0);
  put32(o, uint32_t(w));
  put32(o, uint32_t(h));
  put32(o, 0);
  put32(o, 0);
  put32(o, uint32_t(w));
  put32(o, uint32_t(h));
  put32(o, 0);
  put32(o, 0);
  put16(o, nc);
  for (int c = 0; c < nc; ++c) {
    o.push_back(uint8_t(prec - 1));
    o.push_back(1);
    o.push_back(1);
  }
  put16(o, 0xFF52);  // COD
  put16(o, 12 + nl + 1);
  o.push_back(1);  // precincts defined
  o.push_back(0);  // LRCP
  put16(o, 1);
  o.push_back(0);  // no component transform
  o.push_back(uint8_t(nl));
  o.push_back(kCb - 2);
  o.push_back(kCb - 2);
  o.push_back(0);
  o.push_back(1);  // 5/3
  for (int r = 0; r <= nl; ++r) o.push_back(r == 0 ? uint8_t(kCb | (kCb << 4)) : uint8_t((kCb + 1) | ((kCb + 1) << 4)));
  constexpr int kGuard = 2;
  put16(o, 0xFF5C);  // QCD
  put16(o, 3 + 3 * nl + 1);
  o.push_back(uint8_t(kGuard << 5));
  std::vector<int> expn(size_t(3 * nl + 1));
  for (int b = 0; b < 3 * nl + 1; ++b) {
    int orient = b == 0 ? 0 : (b - 1) % 3 + 1;
    expn[size_t(b)] = prec + (orient == 0 ? 0 : orient == 3 ? 2 : 1);
    o.push_back(uint8_t(expn[size_t(b)] << 3));
  }
  size_t sot = o.size();
  put16(o, 0xFF90);
  put16(o, 10);
  put16(o, 0);
  put32(o, 0);  // Psot, filled in below
  o.push_back(0);
  o.push_back(1);
  put16(o, 0xFF93);
  // the wavelet of each component, columns then rows at each level
  size_t n = size_t(w) * h;
  std::vector<int32_t> coef(planes, planes + n * nc);
  std::vector<int32_t> tmp;
  std::vector<int> rw(size_t(nl + 1)), rh(size_t(nl + 1));
  for (int r = 0; r <= nl; ++r) {
    rw[size_t(r)] = int(ceildivpow2(w, nl - r));
    rh[size_t(r)] = int(ceildivpow2(h, nl - r));
  }
  for (int c = 0; c < nc; ++c) {
    int32_t* a = coef.data() + size_t(c) * n;
    int32_t shift = int32_t(1) << (prec - 1);
    for (size_t i = 0; i < n; ++i) a[i] -= shift;
    for (int r = nl; r >= 1; --r) {
      for (int x = 0; x < rw[size_t(r)]; ++x) fdwt53_1d(a + x, size_t(w), rh[size_t(r)], tmp);
      for (int y = 0; y < rh[size_t(r)]; ++y) fdwt53_1d(a + size_t(y) * w, 1, rw[size_t(r)], tmp);
    }
  }
  // packets in LRCP order: resolution, component, precinct
  std::vector<uint8_t> bytes;
  for (int r = 0; r <= nl; ++r) {
    int pe = r == 0 ? kCb : kCb + 1;
    int64_t pw = rw[size_t(r)] == 0 ? 0 : ceildivpow2(rw[size_t(r)], pe);
    int64_t ph = rh[size_t(r)] == 0 ? 0 : ceildivpow2(rh[size_t(r)], pe);
    for (int c = 0; c < nc; ++c) {
      const int32_t* a = coef.data() + size_t(c) * n;
      for (int64_t p = 0; p < pw * ph; ++p) {
        int64_t bx = (p % pw) << kCb, by = (p / pw) << kCb;  // the code-block's origin in its band
        BitWriter hdr;
        std::vector<uint8_t> body;
        int nb = r == 0 ? 1 : 3;
        struct Entry {
          bool inc;
          int zbp, passes;
          size_t len;
        };
        std::vector<Entry> entries;
        for (int bi = 0; bi < nb; ++bi) {
          int orient = r == 0 ? 0 : bi + 1;
          int64_t ox = 0, oy = 0, bw, bh;
          if (r == 0) {
            bw = rw[0];
            bh = rh[0];
          } else {
            int64_t lw = rw[size_t(r - 1)], lh = rh[size_t(r - 1)];
            ox = (orient & 1) ? lw : 0;
            oy = (orient & 2) ? lh : 0;
            bw = (orient & 1) ? rw[size_t(r)] - lw : lw;
            bh = (orient & 2) ? rh[size_t(r)] - lh : lh;
          }
          if (bx >= bw || by >= bh) continue;  // no code-block of this band in this precinct
          int cw = int(std::min<int64_t>(64, bw - bx)), ch = int(std::min<int64_t>(64, bh - by));
          const int32_t* blk = a + size_t(oy + by) * w + size_t(ox + bx);
          int passes;
          int nbp = encode_block(blk, size_t(w), cw, ch, orient, bytes, &passes);
          int bandno = r == 0 ? 0 : 3 * (r - 1) + bi + 1;
          int mb = expn[size_t(bandno)] + kGuard - 1;
          entries.push_back({nbp > 0, mb - nbp, passes, bytes.size()});
          body.insert(body.end(), bytes.begin(), bytes.end());
        }
        bool any = false;
        for (const Entry& e : entries) any = any || e.inc;
        hdr.bit(any);
        if (any) {
          for (const Entry& e : entries) {
            hdr.bit(e.inc);  // the one-leaf inclusion tree at layer 0
            if (!e.inc) continue;
            for (int z = 0; z < e.zbp; ++z) hdr.bit(0);  // the one-leaf zero bit-plane tree
            hdr.bit(1);
            int np = e.passes;
            if (np == 1) {
              hdr.bit(0);
            } else if (np == 2) {
              hdr.bits(2, 2);
            } else if (np <= 5) {
              hdr.bits(3, 2);
              hdr.bits(uint32_t(np - 3), 2);
            } else if (np <= 36) {
              hdr.bits(15, 4);
              hdr.bits(uint32_t(np - 6), 5);
            } else {
              hdr.bits(511, 9);
              hdr.bits(uint32_t(np - 37), 7);
            }
            int lenbits = 3;
            while ((e.len >> (lenbits + floorlog2(uint32_t(np)))) != 0) ++lenbits;
            for (int i = 3; i < lenbits; ++i) hdr.bit(1);
            hdr.bit(0);
            hdr.bits(uint32_t(e.len), lenbits + floorlog2(uint32_t(np)));
          }
        }
        std::vector<uint8_t> head = hdr.finish();
        o.insert(o.end(), head.begin(), head.end());
        o.insert(o.end(), body.begin(), body.end());
      }
    }
  }
  uint32_t psot = uint32_t(o.size() - sot);
  for (int i = 0; i < 4; ++i) o[sot + 6 + size_t(i)] = uint8_t(psot >> (24 - 8 * i));
  put16(o, 0xFFD9);
  return o;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (errlen > 0) {
    snprintf(err, size_t(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// The image of a codestream: info[0..3] its area on the reference grid
// (x0, y0, x1, y1), info[4] the components, then for each of up to
// `max_comps` components its precision, signedness, dx and dy. Returns 0,
// or -1 with a message in `err`.
int acz_j2k_info(const uint8_t* data, size_t size, int64_t* info, int max_comps, char* err, int errlen) {
  try {
    Bytes b(data, size);
    if (size < 4 || b.u16(0) != 0xFF4F || b.u16(2) != 0xFF51) fail("no SOC and SIZ markers");
    Image im;
    int len = b.u16(4);
    read_siz(b, 6, len - 2, im);
    info[0] = im.x0;
    info[1] = im.y0;
    info[2] = im.x1;
    info[3] = im.y1;
    info[4] = int64_t(im.comps.size());
    for (int c = 0; c < int(im.comps.size()) && c < max_comps; ++c) {
      info[5 + 4 * c] = im.comps[size_t(c)].prec;
      info[6 + 4 * c] = im.comps[size_t(c)].sgnd;
      info[7 + 4 * c] = im.comps[size_t(c)].dx;
      info[8 + 4 * c] = im.comps[size_t(c)].dy;
    }
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return -1;
  }
}

// Decode a codestream into `out`: one int32 plane of the image's size per
// component, each sample as openjpeg leaves it for PIL (shifted and clamped
// to the component's precision). Returns 0, or -1 with a message in `err`.
int acz_j2k_decode(const uint8_t* data, size_t size, int32_t* out, int64_t out_len, char* err, int errlen) {
  try {
    Bytes b(data, size);
    Codestream cs = parse(b);
    const Image& im = cs.im;
    int64_t need = (im.x1 - im.x0) * (im.y1 - im.y0) * int64_t(im.comps.size());
    if (need != out_len) fail("output of %lld samples for %lld", (long long)out_len, (long long)need);
    for (size_t t = 0; t < cs.tiles.size(); ++t) decode_tile(b, cs, t, out);
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_error(err, errlen, "out of memory");
    return -1;
  }
}

// Encode `nc` planes of w x h unsigned samples of `prec` bits (int32) as a
// lossless codestream; *out gets a malloc'ed buffer (free with
// acz_j2k_free). Returns its length, or -1 with a message in `err`.
int64_t acz_j2k_encode(const int32_t* planes, int w, int h, int nc, int prec, uint8_t** out, char* err, int errlen) {
  try {
    if (w <= 0 || h <= 0 || nc <= 0 || nc > 4 || prec < 1 || prec > 16) fail("cannot encode this image");
    std::vector<uint8_t> o = encode(planes, w, h, nc, prec);
    *out = static_cast<uint8_t*>(malloc(o.size()));
    if (!*out) fail("out of memory");
    memcpy(*out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return -1;
  }
}

void acz_j2k_free(void* p) { free(p); }

}  // extern "C"
