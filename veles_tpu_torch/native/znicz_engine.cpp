// znicz_engine: native C++ forward-only inference engine.
//
// The port's copy of native/znicz_engine.cpp, code unchanged, so that an
// exported package runs to the same bits under either package.
// Parity: the reference's libVeles/libZnicz (SURVEY.md §2.6) — a C++
// library that loads a workflow package exported by the Python framework
// (topology.json + weights.bin, see veles_tpu_torch/export.py) and runs
// the forward chain on CPU, for serving without a Python runtime.
//
// Scope: the classic znicz forward ops (fully-connected, conv, max/avg
// pooling, LRN, activations, softmax, LSTM) in NHWC float32 — every
// reference-era model family serves natively — plus the TPU-era
// transformer units (seq_linear/attention/seq_ffn/seq_softmax,
// znicz/transformer.py + znicz/attention.py) so the char-transformer
// family serves too, and switch-MoE routing (znicz/moe.py) — every
// model family in the framework serves natively.
//
// C API (ctypes-consumed by veles_tpu_torch/native_engine.py):
//   void* znicz_load(const char* package_dir);
//   int   znicz_input_size(void* h);          // flattened sample size
//   int   znicz_output_size(void* h);       // flattened per-sample output
//   int   znicz_infer(void* h, const float* x, int n, int sample_len,
//                     float* out, long long out_cap);
//   const char* znicz_error(void* h);
//   void  znicz_free(void* h);

#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal JSON parser (objects/arrays/strings/numbers/bools) — enough for
// the manifests veles_tpu_torch/export.py emits.
// ---------------------------------------------------------------------------

struct Json {
  enum Kind { OBJ, ARR, STR, NUM, BOOL, NUL } kind = NUL;
  std::map<std::string, Json> obj;
  std::vector<Json> arr;
  std::string str;
  double num = 0.0;
  bool b = false;

  const Json& at(const std::string& k) const {
    auto it = obj.find(k);
    if (it == obj.end()) throw std::runtime_error("missing key: " + k);
    return it->second;
  }
  bool has(const std::string& k) const { return obj.count(k) != 0; }
  double numval(const std::string& k, double dflt) const {
    return has(k) ? at(k).num : dflt;
  }
};

struct JsonParser {
  const char* p;
  const char* end;
  explicit JsonParser(const std::string& s)
      : p(s.data()), end(s.data() + s.size()) {}

  void skip() {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r'))
      ++p;
  }
  char peek() {
    skip();
    if (p >= end) throw std::runtime_error("unexpected end of json");
    return *p;
  }
  void expect(char c) {
    if (peek() != c)
      throw std::runtime_error(std::string("expected '") + c + "'");
    ++p;
  }

  Json parse() {
    char c = peek();
    if (c == '{') return parse_obj();
    if (c == '[') return parse_arr();
    if (c == '"') return parse_str();
    if (c == 't' || c == 'f') return parse_bool();
    if (c == 'n') { p += 4; return Json{}; }
    return parse_num();
  }
  Json parse_obj() {
    Json j; j.kind = Json::OBJ;
    expect('{');
    if (peek() == '}') { ++p; return j; }
    while (true) {
      Json key = parse_str();
      expect(':');
      j.obj[key.str] = parse();
      if (peek() == ',') { ++p; continue; }
      expect('}');
      return j;
    }
  }
  Json parse_arr() {
    Json j; j.kind = Json::ARR;
    expect('[');
    if (peek() == ']') { ++p; return j; }
    while (true) {
      j.arr.push_back(parse());
      if (peek() == ',') { ++p; continue; }
      expect(']');
      return j;
    }
  }
  Json parse_str() {
    Json j; j.kind = Json::STR;
    expect('"');
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) ++p;
      j.str += *p++;
    }
    expect('"');
    return j;
  }
  Json parse_bool() {
    Json j; j.kind = Json::BOOL;
    if (*p == 't') { j.b = true; p += 4; } else { j.b = false; p += 5; }
    return j;
  }
  Json parse_num() {
    Json j; j.kind = Json::NUM;
    char* q = nullptr;
    j.num = std::strtod(p, &q);
    if (q == p) throw std::runtime_error("bad number in json");
    p = q;
    return j;
  }
};

// ---------------------------------------------------------------------------
// Tensor + ops (NHWC float32)
// ---------------------------------------------------------------------------

struct Tensor {
  std::vector<int> shape;  // leading dim = batch
  std::vector<float> data;
  int size() const {
    int s = 1;
    for (int d : shape) s *= d;
    return s;
  }
};

const float TANH_A = 1.7159f;
const float TANH_B = 0.6666f;

float activate(const std::string& act, float x) {
  if (act == "linear") return x;
  if (act == "tanh") return TANH_A * std::tanh(TANH_B * x);
  if (act == "relu") {  // reference smooth RELU = softplus
    if (x > 30.f) return x;
    return std::log1p(std::exp(x));
  }
  if (act == "strictrelu") return x > 0.f ? x : 0.f;
  if (act == "sigmoid") return 1.f / (1.f + std::exp(-x));
  if (act == "log") return std::asinh(x);
  throw std::runtime_error("unknown activation: " + act);
}

// y (M, N_out) += x (M, K) @ w (K, N_out); y must be pre-initialized.
// Skips zero inputs (one-hot token rows are mostly zero).
void matmul_acc(const float* x, const float* w, float* y, int M, int K,
                int N_out) {
  for (int m = 0; m < M; ++m) {
    const float* xr = x + (size_t)m * K;
    float* yr = y + (size_t)m * N_out;
    for (int k = 0; k < K; ++k) {
      float xv = xr[k];
      if (xv == 0.f) continue;
      const float* wr = w + (size_t)k * N_out;
      for (int o = 0; o < N_out; ++o) yr[o] += xv * wr[o];
    }
  }
}

void softmax_row(float* r, int n) {
  float m = r[0];
  for (int i = 1; i < n; ++i) m = std::max(m, r[i]);
  float tot = 0.f;
  for (int i = 0; i < n; ++i) { r[i] = std::exp(r[i] - m); tot += r[i]; }
  for (int i = 0; i < n; ++i) r[i] /= tot;
}

// y[n, o] = act(sum_i x[n, i] w[i, o] + b[o]); x flattened per sample.
void all2all(const Tensor& x, const std::vector<float>& w,
             const std::vector<float>& b, int in_dim, int out_dim,
             const std::string& act, bool softmax, Tensor* y) {
  int n = x.shape[0];
  y->shape = {n, out_dim};
  y->data.assign((size_t)n * out_dim, 0.f);
  matmul_acc(x.data.data(), w.data(), y->data.data(), n, in_dim, out_dim);
  for (int s = 0; s < n; ++s) {
    float* ys = y->data.data() + (size_t)s * out_dim;
    for (int o = 0; o < out_dim; ++o) ys[o] = activate(act, ys[o] + b[o]);
    if (softmax) softmax_row(ys, out_dim);
  }
}

// NHWC conv; w: (ky, kx, c, k) like the XLA path.
void conv2d(const Tensor& x, const std::vector<float>& w,
            const std::vector<float>& b, int ky, int kx, int sy, int sx,
            int py, int px, int n_kernels, const std::string& act,
            Tensor* y) {
  int n = x.shape[0], h = x.shape[1], wd = x.shape[2], c = x.shape[3];
  int oh = (h + 2 * py - ky) / sy + 1;
  int ow = (wd + 2 * px - kx) / sx + 1;
  y->shape = {n, oh, ow, n_kernels};
  y->data.assign((size_t)n * oh * ow * n_kernels, 0.f);
  for (int s = 0; s < n; ++s)
    for (int i = 0; i < oh; ++i)
      for (int j = 0; j < ow; ++j) {
        float* out = y->data.data()
            + (((size_t)s * oh + i) * ow + j) * n_kernels;
        for (int di = 0; di < ky; ++di) {
          int yy = i * sy + di - py;
          if (yy < 0 || yy >= h) continue;
          for (int dj = 0; dj < kx; ++dj) {
            int xx = j * sx + dj - px;
            if (xx < 0 || xx >= wd) continue;
            const float* xin = x.data.data()
                + (((size_t)s * h + yy) * wd + xx) * c;
            const float* wr = w.data()
                + (((size_t)di * kx + dj) * c) * n_kernels;
            for (int ci = 0; ci < c; ++ci) {
              float xv = xin[ci];
              const float* wc = wr + (size_t)ci * n_kernels;
              for (int k = 0; k < n_kernels; ++k) out[k] += xv * wc[k];
            }
          }
        }
        for (int k = 0; k < n_kernels; ++k)
          out[k] = activate(act, out[k] + b[k]);
      }
}

// ceil-mode pooling with truncated edge windows (ops.reference semantics).
void pool2d(const Tensor& x, int ky, int kx, int sy, int sx, bool is_max,
            bool use_abs, Tensor* y) {
  int n = x.shape[0], h = x.shape[1], w = x.shape[2], c = x.shape[3];
  int oh = h > ky ? (h - ky + sy - 1) / sy + 1 : 1;
  int ow = w > kx ? (w - kx + sx - 1) / sx + 1 : 1;
  y->shape = {n, oh, ow, c};
  y->data.assign((size_t)n * oh * ow * c, 0.f);
  for (int s = 0; s < n; ++s)
    for (int i = 0; i < oh; ++i)
      for (int j = 0; j < ow; ++j)
        for (int ci = 0; ci < c; ++ci) {
          int y0 = i * sy, x0 = j * sx;
          int y1 = std::min(y0 + ky, h), x1 = std::min(x0 + kx, w);
          float best = 0.f, sum = 0.f;
          bool first = true;
          int cnt = 0;
          for (int yy = y0; yy < y1; ++yy)
            for (int xx = x0; xx < x1; ++xx) {
              float v = x.data[(((size_t)s * h + yy) * w + xx) * c + ci];
              sum += v;
              ++cnt;
              float key = use_abs ? std::fabs(v) : v;
              float bkey = use_abs ? std::fabs(best) : best;
              if (first || key > bkey) { best = v; first = false; }
            }
          y->data[(((size_t)s * oh + i) * ow + j) * c + ci] =
              is_max ? best : sum / cnt;
        }
}

// Position-wise linear over (N, S, Din): y = act(x @ W + b [+ pos]).
// softmax=true additionally applies a per-position softmax and flattens
// to (N*S, V) — the SeqSoftmax layout (znicz/transformer.py).
void seq_linear(const Tensor& x, const std::vector<float>& w,
                const std::vector<float>& b, const std::vector<float>& pos,
                int dout, const std::string& act, bool softmax, Tensor* y) {
  if (x.shape.size() != 3)
    throw std::runtime_error("seq_linear expects (N, S, D) input");
  int n = x.shape[0], s = x.shape[1], din = x.shape[2];
  if (softmax) y->shape = {n * s, dout};
  else y->shape = {n, s, dout};
  y->data.assign((size_t)n * s * dout, 0.f);
  matmul_acc(x.data.data(), w.data(), y->data.data(), n * s, din, dout);
  for (int r = 0; r < n * s; ++r) {
    float* yr = y->data.data() + (size_t)r * dout;
    const float* pr =
        pos.empty() ? nullptr : pos.data() + (size_t)(r % s) * dout;
    for (int o = 0; o < dout; ++o) {
      float v = yr[o] + b[o] + (pr ? pr[o] : 0.f);
      yr[o] = activate(act, v);
    }
    if (softmax) softmax_row(yr, dout);
  }
}

// Transformer FFN block with residual: y = x + act(x@W1 + b1)@W2 + b2.
void seq_ffn(const Tensor& x, const std::vector<float>& w1,
             const std::vector<float>& b1, const std::vector<float>& w2,
             const std::vector<float>& b2, int hidden,
             const std::string& act, Tensor* y) {
  if (x.shape.size() != 3)
    throw std::runtime_error("seq_ffn expects (N, S, E) input");
  int rows = x.shape[0] * x.shape[1], e = x.shape[2];
  std::vector<float> mid((size_t)rows * hidden, 0.f);
  matmul_acc(x.data.data(), w1.data(), mid.data(), rows, e, hidden);
  for (int r = 0; r < rows; ++r)
    for (int h = 0; h < hidden; ++h) {
      float& v = mid[(size_t)r * hidden + h];
      v = activate(act, v + b1[h]);
    }
  y->shape = x.shape;
  y->data = x.data;  // residual base
  matmul_acc(mid.data(), w2.data(), y->data.data(), rows, hidden, e);
  for (int r = 0; r < rows; ++r)
    for (int o = 0; o < e; ++o) y->data[(size_t)r * e + o] += b2[o];
}

// Multi-head self-attention (ops/attention.py:mha_forward semantics):
// scale 1/sqrt(D), optional causal mask, softmax over keys; params
// wq/wk/wv (E, H*D), wo (H*D, E); optional residual add.
void attention(const Tensor& x, const std::vector<float>& wq,
               const std::vector<float>& wk, const std::vector<float>& wv,
               const std::vector<float>& wo, int head_dim, bool causal,
               bool residual, Tensor* y) {
  if (x.shape.size() != 3)
    throw std::runtime_error("attention expects (N, S, E) input");
  int n = x.shape[0], s = x.shape[1], e = x.shape[2];
  int hd = (int)(wq.size() / e);           // H*D
  int heads = hd / head_dim;
  if (heads * head_dim != hd || (size_t)e * hd != wq.size())
    throw std::runtime_error("attention wq shape mismatch");
  float scale = 1.0f / std::sqrt((float)head_dim);
  int rows = n * s;
  std::vector<float> q((size_t)rows * hd, 0.f), k(q), v(q), o(q);
  matmul_acc(x.data.data(), wq.data(), q.data(), rows, e, hd);
  matmul_acc(x.data.data(), wk.data(), k.data(), rows, e, hd);
  matmul_acc(x.data.data(), wv.data(), v.data(), rows, e, hd);
  std::vector<float> sc(s);
  for (int b = 0; b < n; ++b)
    for (int h = 0; h < heads; ++h)
      for (int qi = 0; qi < s; ++qi) {
        const float* qr =
            q.data() + ((size_t)b * s + qi) * hd + (size_t)h * head_dim;
        int kmax = causal ? qi + 1 : s;
        for (int ki = 0; ki < kmax; ++ki) {
          const float* kr =
              k.data() + ((size_t)b * s + ki) * hd + (size_t)h * head_dim;
          float dot = 0.f;
          for (int d = 0; d < head_dim; ++d) dot += qr[d] * kr[d];
          sc[ki] = dot * scale;
        }
        softmax_row(sc.data(), kmax);
        float* orow =
            o.data() + ((size_t)b * s + qi) * hd + (size_t)h * head_dim;
        for (int ki = 0; ki < kmax; ++ki) {
          const float* vr =
              v.data() + ((size_t)b * s + ki) * hd + (size_t)h * head_dim;
          float p = sc[ki];
          for (int d = 0; d < head_dim; ++d) orow[d] += p * vr[d];
        }
      }
  y->shape = x.shape;
  if (residual) y->data = x.data;
  else y->data.assign((size_t)rows * e, 0.f);
  matmul_acc(o.data(), wo.data(), y->data.data(), rows, hd, e);
}

// LSTM over time. x: (N, T, D); wx: (D, 4H), wh: (H, 4H), b: (4H).
// Gate order [i, f, g, o] (ops/reference.py:lstm_step); plain tanh for
// the candidate/cell (NOT the scaled all2all tanh). Output rows are the
// per-timestep hidden states flattened to (N*T, H) — exactly the Python
// LSTM unit's layout (znicz/lstm.py), so a following all2all/softmax
// projection consumes per-timestep predictions unchanged.
void lstm(const Tensor& x, const std::vector<float>& wx,
          const std::vector<float>& wh, const std::vector<float>& b,
          int hsz, Tensor* y) {
  if (x.shape.size() != 3)
    throw std::runtime_error("lstm expects (N, T, D) input");
  int n = x.shape[0], T = x.shape[1], d = x.shape[2];
  y->shape = {n * T, hsz};
  y->data.assign((size_t)n * T * hsz, 0.f);
  std::vector<float> h(hsz), c(hsz), z(4 * hsz);
  auto sig = [](float v) { return 1.f / (1.f + std::exp(-v)); };
  for (int s = 0; s < n; ++s) {
    std::fill(h.begin(), h.end(), 0.f);
    std::fill(c.begin(), c.end(), 0.f);
    for (int t = 0; t < T; ++t) {
      const float* xt = x.data.data() + ((size_t)s * T + t) * d;
      std::copy(b.begin(), b.end(), z.begin());
      for (int i = 0; i < d; ++i) {
        float xv = xt[i];
        if (xv == 0.f) continue;  // one-hot char inputs are mostly zero
        const float* wr = wx.data() + (size_t)i * 4 * hsz;
        for (int g = 0; g < 4 * hsz; ++g) z[g] += xv * wr[g];
      }
      for (int i = 0; i < hsz; ++i) {
        float hv = h[i];
        if (hv == 0.f) continue;
        const float* wr = wh.data() + (size_t)i * 4 * hsz;
        for (int g = 0; g < 4 * hsz; ++g) z[g] += hv * wr[g];
      }
      float* out = y->data.data() + ((size_t)s * T + t) * hsz;
      for (int i = 0; i < hsz; ++i) {
        float ig = sig(z[i]);
        float fg = sig(z[hsz + i]);
        float gg = std::tanh(z[2 * hsz + i]);
        float og = sig(z[3 * hsz + i]);
        c[i] = fg * c[i] + ig * gg;
        h[i] = og * std::tanh(c[i]);
        out[i] = h[i];
      }
    }
  }
}

// AlexNet-style across-channel LRN.
void lrn(const Tensor& x, float k, float alpha, float beta, int nwin,
         Tensor* y) {
  int total = x.size();
  int c = x.shape.back();
  int half = nwin / 2;
  y->shape = x.shape;
  y->data.assign(total, 0.f);
  int rows = total / c;
  for (int r = 0; r < rows; ++r) {
    const float* xr = x.data.data() + (size_t)r * c;
    float* yr = y->data.data() + (size_t)r * c;
    for (int ci = 0; ci < c; ++ci) {
      float ssum = 0.f;
      for (int d = -half; d <= half; ++d) {
        int cc = ci + d;
        if (cc >= 0 && cc < c) ssum += xr[cc] * xr[cc];
      }
      yr[ci] = xr[ci] * std::pow(k + alpha * ssum, -beta);
    }
  }
}

// ---------------------------------------------------------------------------
// Engine
// ---------------------------------------------------------------------------

struct Layer {
  std::string type;
  std::string activation = "linear";
  bool softmax = false;
  bool use_abs = false;
  int ky = 0, kx = 0, sy = 1, sx = 1, py = 0, px = 0;
  float k = 2.f, alpha = 1e-4f, beta = 0.75f;
  int nwin = 5;
  float scale = 1.f, offset = 0.f;  // "affine" (input_normalize export)
  int head_dim = 0;
  bool causal = false, residual = false, pos_embed = false;
  int n_experts = 0, hidden = 0;          // moe
  // double, matching the Python side's arithmetic exactly: a float32
  // round here could truncate the capacity one below the golden's
  double capacity_factor = 2.0;           // moe
  std::string route;                      // moe: "token" | "sample"
  std::vector<int> w_shape;
  std::vector<float> weights, bias;
  // third packed array for ops with >2 params (lstm: [wx, wh, b] ->
  // weights, w2, bias)
  std::vector<float> w2;
  // full blob list for ops with >3 params (attention [wq,wk,wv,wo],
  // seq_ffn [w1,b1,w2,b2]); weights/w2/bias stay empty for those
  std::vector<std::vector<float>> arrs;
};

struct Engine {
  std::vector<Layer> layers;
  std::vector<int> input_shape;  // per-sample
  std::string error;
};

// Switch MoE twin of ops/moe.py:moe_forward (export.py:_export_moe):
// per token — softmax router over E experts, FIRST-argmax expert with
// in-order per-expert capacity (prefix count over ALL tokens routed to
// that expert, kept or not, matching top1_dispatch's cumsum), dropped
// tokens emit 0 (the caller's residual add keeps them alive, like the
// python layer); kept tokens emit gate · (relu(x@w1_e+b1_e)@w2_e+b2_e).
// Blobs: [wr (D,E), w1 (E,D,H), b1 (E,H), w2 (E,H,D), b2 (E,D)].
void moe_tokens(const std::vector<float>& x, int tcount, int d,
                const Layer& l, std::vector<float>* y) {
  const std::vector<float>& wr = l.arrs[0];
  const std::vector<float>& w1 = l.arrs[1];
  const std::vector<float>& b1 = l.arrs[2];
  const std::vector<float>& w2 = l.arrs[3];
  const std::vector<float>& b2 = l.arrs[4];
  const int e_n = l.n_experts, hid = l.hidden;
  if ((long long)wr.size() != (long long)d * e_n ||
      (long long)w1.size() != (long long)e_n * d * hid ||
      (long long)b1.size() != (long long)e_n * hid ||
      (long long)w2.size() != (long long)e_n * hid * d ||
      (long long)b2.size() != (long long)e_n * d)
    throw std::runtime_error("moe blob size mismatch");
  // python: int(capacity_factor * n_tokens / n_experts) — same double
  // arithmetic + truncation, clamped to >= 1 (cf <= 1e9 is enforced at
  // load, so the product stays far below the long long range)
  long long cap = (long long)(l.capacity_factor * tcount / e_n);
  if (cap < 1) cap = 1;
  std::vector<long long> count(e_n, 0);
  std::vector<float> logits(e_n), h(hid);
  y->assign((size_t)tcount * d, 0.f);
  for (int t = 0; t < tcount; ++t) {
    const float* xt = x.data() + (size_t)t * d;
    float mx = -std::numeric_limits<float>::infinity();
    for (int e = 0; e < e_n; ++e) {
      double acc = 0.0;
      for (int i = 0; i < d; ++i)
        acc += (double)xt[i] * wr[(size_t)i * e_n + e];
      logits[e] = (float)acc;
      if (logits[e] > mx) mx = logits[e];
    }
    double denom = 0.0;
    for (int e = 0; e < e_n; ++e)
      denom += std::exp((double)logits[e] - mx);
    int best = 0;                    // strict > keeps the FIRST max,
    for (int e = 1; e < e_n; ++e)    // matching jnp.argmax tie-break
      if (logits[e] > logits[best]) best = e;
    long long pos = count[best]++;
    if (pos >= cap) continue;        // over capacity: dropped, stays 0
    float gate = (float)(std::exp((double)logits[best] - mx) / denom);
    const float* w1e = w1.data() + (size_t)best * d * hid;
    const float* b1e = b1.data() + (size_t)best * hid;
    const float* w2e = w2.data() + (size_t)best * hid * d;
    const float* b2e = b2.data() + (size_t)best * d;
    for (int j = 0; j < hid; ++j) {
      double acc = b1e[j];
      for (int i = 0; i < d; ++i)
        acc += (double)xt[i] * w1e[(size_t)i * hid + j];
      h[j] = acc > 0.0 ? (float)acc : 0.f;
    }
    float* yt = y->data() + (size_t)t * d;
    for (int i = 0; i < d; ++i) {
      double acc = b2e[i];
      for (int j = 0; j < hid; ++j)
        acc += (double)h[j] * w2e[(size_t)j * d + i];
      yt[i] = gate * (float)acc;
    }
  }
}

std::vector<float> read_blob(const std::vector<float>& pool, const Json& spec) {
  // Packages travel through the forge/zoo exchange, so treat the manifest
  // as untrusted: validate each JSON double BEFORE casting (double->int
  // conversion of an out-of-range value is UB), then 64-bit arithmetic
  // with a subtraction-form bounds check that cannot itself overflow.
  auto to_index = [](double v) -> long long {
    if (!(v >= 0 && v <= 9007199254740992.0 /* 2^53 */) ||
        v != std::floor(v))
      throw std::runtime_error("bad offset/shape value in manifest");
    return (long long)v;
  };
  long long offset = to_index(spec.at("offset").num);
  long long sz = 1;
  for (const auto& d : spec.at("shape").arr) {
    long long dim = to_index(d.num);
    if (dim > 0 && sz > (long long)pool.size() / dim)
      throw std::runtime_error("bad shape in manifest");
    sz *= dim;
  }
  if (offset < 0 || (size_t)offset > pool.size() ||
      (size_t)sz > pool.size() - (size_t)offset)
    throw std::runtime_error("weights.bin too small for manifest");
  return std::vector<float>(pool.begin() + (size_t)offset,
                            pool.begin() + (size_t)offset + (size_t)sz);
}

Engine* load_package(const std::string& dir) {
  auto eng = std::make_unique<Engine>();
  std::ifstream mf(dir + "/topology.json");
  if (!mf) throw std::runtime_error("cannot open topology.json in " + dir);
  std::stringstream ss;
  ss << mf.rdbuf();
  std::string text = ss.str();
  Json root = JsonParser(text).parse();
  if (root.at("format").str != "veles_tpu-package-v1")
    throw std::runtime_error("unknown package format");
  for (const auto& d : root.at("input_shape").arr)
    eng->input_shape.push_back((int)d.num);

  std::ifstream wb(dir + "/weights.bin", std::ios::binary);
  if (!wb) throw std::runtime_error("cannot open weights.bin in " + dir);
  wb.seekg(0, std::ios::end);
  size_t bytes = (size_t)wb.tellg();
  wb.seekg(0);
  std::vector<float> pool(bytes / sizeof(float));
  wb.read(reinterpret_cast<char*>(pool.data()), bytes);

  for (const auto& lj : root.at("layers").arr) {
    Layer l;
    l.type = lj.at("type").str;
    if (lj.has("activation")) l.activation = lj.at("activation").str;
    if (lj.has("softmax")) l.softmax = lj.at("softmax").b;
    if (lj.has("use_abs")) l.use_abs = lj.at("use_abs").b;
    if (lj.has("stride")) {
      l.sy = (int)lj.at("stride").arr[0].num;
      l.sx = (int)lj.at("stride").arr[1].num;
    }
    if (lj.has("padding")) {
      l.py = (int)lj.at("padding").arr[0].num;
      l.px = (int)lj.at("padding").arr[1].num;
    }
    if (lj.has("ksize")) {
      l.ky = (int)lj.at("ksize").arr[0].num;
      l.kx = (int)lj.at("ksize").arr[1].num;
    }
    l.k = (float)lj.numval("k", 2.0);
    l.alpha = (float)lj.numval("alpha", 1e-4);
    l.beta = (float)lj.numval("beta", 0.75);
    l.nwin = (int)lj.numval("n", 5);
    l.scale = (float)lj.numval("scale", 1.0);
    l.offset = (float)lj.numval("offset", 0.0);
    l.head_dim = (int)lj.numval("head_dim", 0);
    if (lj.has("causal")) l.causal = lj.at("causal").b;
    if (lj.has("residual")) l.residual = lj.at("residual").b;
    if (lj.has("pos_embed")) l.pos_embed = lj.at("pos_embed").b;
    // untrusted manifest (see read_blob): validate BEFORE casting —
    // double->int conversion of an out-of-range/NaN value is UB
    auto dim_int = [](double v, const char* what) -> int {
      if (!(v >= 0 && v <= 1e9) || v != std::floor(v))
        throw std::runtime_error(std::string("bad ") + what +
                                 " in manifest");
      return (int)v;
    };
    l.n_experts = dim_int(lj.numval("n_experts", 0), "n_experts");
    l.hidden = dim_int(lj.numval("hidden", 0), "hidden");
    l.capacity_factor = lj.numval("capacity_factor", 2.0);
    if (!(l.capacity_factor >= 0 && l.capacity_factor <= 1e9))
      throw std::runtime_error("bad capacity_factor in manifest");
    if (lj.has("route")) l.route = lj.at("route").str;
    const auto& arrays = lj.at("arrays").arr;
    if (!arrays.empty()) {
      l.weights = read_blob(pool, arrays[0]);
      for (const auto& d : arrays[0].at("shape").arr)
        l.w_shape.push_back((int)d.num);
      // 2 arrays: [weights, bias]; 3 arrays: [weights, w2, bias];
      // 4+ arrays: the full list goes to l.arrs instead (attention
      // [wq,wk,wv,wo], seq_ffn [w1,b1,w2,b2]) — no double-read
      if (arrays.size() == 2) {
        l.bias = read_blob(pool, arrays[1]);
      } else if (arrays.size() == 3) {
        l.w2 = read_blob(pool, arrays[1]);
        l.bias = read_blob(pool, arrays[2]);
      } else if (arrays.size() > 3) {
        l.arrs.push_back(std::move(l.weights));
        l.weights.clear();
        for (size_t ai = 1; ai < arrays.size(); ++ai)
          l.arrs.push_back(read_blob(pool, arrays[ai]));
      }
    }
    eng->layers.push_back(std::move(l));
  }
  return eng.release();
}

void run_forward(Engine* eng, Tensor* t) {
  for (const auto& l : eng->layers) {
    Tensor out;
    if (l.type == "all2all") {
      int in_dim = l.w_shape[0], out_dim = l.w_shape[1];
      // flatten per sample
      Tensor flat;
      flat.shape = {t->shape[0], t->size() / t->shape[0]};
      flat.data = std::move(t->data);
      if (flat.shape[1] != in_dim)
        throw std::runtime_error("all2all input size mismatch");
      all2all(flat, l.weights, l.bias, in_dim, out_dim, l.activation,
              l.softmax, &out);
    } else if (l.type == "conv") {
      int ky = l.w_shape[0], kx = l.w_shape[1], nk = l.w_shape[3];
      conv2d(*t, l.weights, l.bias, ky, kx, l.sy, l.sx, l.py, l.px, nk,
             l.activation, &out);
    } else if (l.type == "max_pooling") {
      pool2d(*t, l.ky, l.kx, l.sy, l.sx, true, l.use_abs, &out);
    } else if (l.type == "avg_pooling") {
      pool2d(*t, l.ky, l.kx, l.sy, l.sx, false, false, &out);
    } else if (l.type == "seq_linear" || l.type == "seq_softmax") {
      // arrays: [weights, bias] or [weights, pos, bias] (pos_embed)
      int dout = l.w_shape[1];
      static const std::vector<float> kNoPos;
      const std::vector<float>& pos = l.pos_embed ? l.w2 : kNoPos;
      if (l.pos_embed && l.w2.empty())
        throw std::runtime_error("seq_linear pos_embed without pos blob");
      if (l.bias.size() != (size_t)dout)
        throw std::runtime_error("seq_linear bias size mismatch");
      seq_linear(*t, l.weights, l.bias, pos, dout, l.activation,
                 l.type == "seq_softmax", &out);
    } else if (l.type == "seq_ffn") {
      // arrays: [w1 (E,H), b1 (H), w2 (H,E), b2 (E)]
      if (l.arrs.size() != 4)
        throw std::runtime_error("seq_ffn expects 4 arrays");
      int hidden = l.w_shape[1];
      seq_ffn(*t, l.arrs[0], l.arrs[1], l.arrs[2], l.arrs[3], hidden,
              l.activation, &out);
    } else if (l.type == "attention") {
      // arrays: [wq, wk, wv, wo] each (E, H*D) / (H*D, E)
      if (l.arrs.size() != 4 || l.head_dim <= 0)
        throw std::runtime_error("attention expects 4 arrays + head_dim");
      attention(*t, l.arrs[0], l.arrs[1], l.arrs[2], l.arrs[3],
                l.head_dim, l.causal, l.residual, &out);
    } else if (l.type == "lstm") {
      // arrays = [wx (D,4H), wh (H,4H), b (4H)] (export.py:_export_lstm)
      int hsz = l.w_shape[1] / 4;
      if (t->shape.size() != 3 ||
          l.weights.size() != (size_t)t->shape[2] * 4 * hsz)
        throw std::runtime_error("lstm wx size does not match input");
      if (l.w2.size() != (size_t)hsz * 4 * hsz ||
          l.bias.size() != 4 * (size_t)hsz)
        throw std::runtime_error("lstm wh/b blob size mismatch");
      lstm(*t, l.weights, l.w2, l.bias, hsz, &out);
    } else if (l.type == "moe") {
      // arrays: [wr, w1, b1, w2, b2] (export.py:_export_moe)
      if (l.arrs.size() != 5 || l.n_experts <= 0 || l.hidden <= 0)
        throw std::runtime_error("moe expects 5 arrays + n_experts/hidden");
      bool token = l.route == "token";
      int tcount, d;
      if (token) {
        if (t->shape.size() != 3)
          throw std::runtime_error("moe token route expects (N,S,D)");
        tcount = t->shape[0] * t->shape[1];
        d = t->shape[2];
      } else {
        tcount = t->shape[0];
        d = (int)(t->size() / t->shape[0]);
      }
      moe_tokens(t->data, tcount, d, l, &out.data);
      out.shape = token ? t->shape : std::vector<int>{t->shape[0], d};
      if (l.residual)
        for (size_t i = 0; i < out.data.size(); ++i)
          out.data[i] += t->data[i];
    } else if (l.type == "lrn") {
      lrn(*t, l.k, l.alpha, l.beta, l.nwin, &out);
    } else if (l.type == "activation") {
      out.shape = t->shape;
      out.data.resize(t->data.size());
      for (size_t i = 0; i < t->data.size(); ++i)
        out.data[i] = activate(l.activation, t->data[i]);
    } else if (l.type == "affine") {
      // input_normalize export: y = x*scale + offset - mean (mean is an
      // optional per-sample-shaped blob in weights)
      size_t sample = (size_t)(t->size() / t->shape[0]);
      if (!l.weights.empty() && l.weights.size() != sample)
        throw std::runtime_error("affine mean size mismatch");
      out.shape = t->shape;
      out.data.resize(t->data.size());
      size_t n = t->data.size() / sample;
      for (size_t b = 0; b < n; ++b) {      // sample-major: direct mean
        const float* src = t->data.data() + b * sample;
        float* dst = out.data.data() + b * sample;
        if (l.weights.empty()) {
          for (size_t i = 0; i < sample; ++i)
            dst[i] = src[i] * l.scale + l.offset;
        } else {
          for (size_t i = 0; i < sample; ++i)
            dst[i] = src[i] * l.scale + l.offset - l.weights[i];
        }
      }
    } else if (l.type == "identity") {
      continue;
    } else {
      throw std::runtime_error("unknown layer type: " + l.type);
    }
    *t = std::move(out);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

void* znicz_load(const char* package_dir) {
  try {
    return load_package(package_dir);
  } catch (const std::exception& e) {
    auto* eng = new Engine();
    eng->error = e.what();
    eng->layers.clear();
    eng->input_shape.clear();
    return eng;
  }
}

const char* znicz_error(void* h) {
  auto* eng = static_cast<Engine*>(h);
  return eng->error.empty() ? nullptr : eng->error.c_str();
}

int znicz_input_size(void* h) {
  auto* eng = static_cast<Engine*>(h);
  int s = 1;
  for (int d : eng->input_shape) s *= d;
  return s;
}

// Per-sample output size, computed by pushing one zero sample through the
// chain (exact shape inference; cheap relative to any real batch).
int znicz_output_size(void* h) {
  auto* eng = static_cast<Engine*>(h);
  try {
    Tensor t;
    t.shape.push_back(1);
    for (int d : eng->input_shape) t.shape.push_back(d);
    t.data.assign(t.size(), 0.f);
    run_forward(eng, &t);
    return t.size();
  } catch (const std::exception& e) {
    eng->error = e.what();
    return -1;
  }
}

// Run n samples of sample_len floats; writes n * out_dim floats into out.
// Returns the per-sample output size, or -1 on error.
int znicz_infer(void* h, const float* x, int n, int sample_len, float* out,
                long long out_cap) {
  auto* eng = static_cast<Engine*>(h);
  try {
    if (n <= 0) throw std::runtime_error("batch must be positive");
    Tensor t;
    t.shape.push_back(n);
    for (int d : eng->input_shape) t.shape.push_back(d);
    if (t.size() != n * sample_len)
      throw std::runtime_error("sample_len does not match input_shape");
    t.data.assign(x, x + (size_t)n * sample_len);
    run_forward(eng, &t);
    int out_dim = t.size() / n;
    if ((long long)n * out_dim > out_cap)
      throw std::runtime_error("output buffer too small");
    std::memcpy(out, t.data.data(), sizeof(float) * (size_t)n * out_dim);
    return out_dim;
  } catch (const std::exception& e) {
    eng->error = e.what();
    return -1;
  }
}

void znicz_free(void* h) { delete static_cast<Engine*>(h); }

}  // extern "C"
