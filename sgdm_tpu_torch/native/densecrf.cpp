// Dense CRF mean-field inference with permutohedral-lattice filtering.
//
// Native replacement for pydensecrf (C++), which the reference uses to
// refine STEGO segmentation masks (side_repo/STEGO/src/crf.py:22-46:
// unary from softmax probs, PairwiseGaussian(sxy=1, compat=3) +
// PairwiseBilateral(sxy=67, srgb=3, compat=4), 10 mean-field iterations).
//
// The high-dimensional Gaussian filter is the permutohedral lattice
// (Adams, Baek, Davis 2010): embed d-dim features on the hyperplane
// H_d ⊂ R^{d+1}, locate the enclosing simplex by differential sorting,
// splat with barycentric weights into a hashed sparse lattice, blur along
// each lattice direction, slice back.  O(N·d²) per filter pass.
//
// Exposed C API (ctypes):
//   void dense_crf_inference(const float* unary_logits, // [C*H*W], class-major
//                            const unsigned char* rgb,  // [H*W*3]
//                            int H, int W, int C, int iters,
//                            float pos_w, float pos_xy_std,
//                            float bi_w, float bi_xy_std, float bi_rgb_std,
//                            float* out_probs)           // [C*H*W]
//
// The port's copy of sgdm_tpu/native/densecrf.cpp, the same code line for
// line (plus the <algorithm> include std::max needs); built by
// native/__init__.py load_library("densecrf") with the package's CXX_FLAGS.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------
// Permutohedral lattice
// ---------------------------------------------------------------------
class Permutohedral {
 public:
  void init(const float* features, int d, int n) {
    d_ = d;
    n_ = n;
    const int dp1 = d + 1;
    offsets_.assign((size_t)n * dp1, 0);
    weights_.assign((size_t)n * dp1, 0.f);

    std::vector<float> elevated(dp1), rem0(dp1), barycentric(dp1 + 1);
    std::vector<int> rank(dp1), key(d);

    // scale so that lattice spacing matches unit-variance Gaussians
    std::vector<float> scale(d);
    for (int i = 0; i < d; ++i)
      scale[i] = 1.0f / std::sqrt((float)(i + 2) * (i + 1)) *
                 (dp1)*std::sqrt(2.0f / 3.0f);

    // bucket by 64-bit FNV but CONFIRM the full key on every probe —
    // Adams et al. / pydensecrf compare keys too; hash-only dedup would
    // silently merge unrelated lattice points on a collision
    std::unordered_multimap<std::uint64_t, int> hash;
    hash.reserve((size_t)n * 2);
    std::vector<std::vector<int>> keys;  // lattice point keys (first d coords)

    auto find_key = [&](std::uint64_t h, const int* k) -> int {
      auto range = hash.equal_range(h);
      for (auto it = range.first; it != range.second; ++it) {
        const std::vector<int>& stored = keys[it->second];
        bool same = true;
        for (int j = 0; j < d_; ++j)
          if (stored[j] != k[j]) { same = false; break; }
        if (same) return it->second;
      }
      return -1;
    };

    auto hash_key = [&](const int* k) {
      std::uint64_t h = 1469598103934665603ull;
      for (int i = 0; i < d_; ++i) {
        h ^= (std::uint64_t)(std::uint32_t)k[i];
        h *= 1099511628211ull;
      }
      return h;
    };

    for (int i = 0; i < n; ++i) {
      const float* f = features + (size_t)i * d;
      // elevate to H_d: E x, using the efficient recurrence
      float sm = 0.f;
      for (int j = d; j > 0; --j) {
        float cf = f[j - 1] * scale[j - 1];
        elevated[j] = sm - (float)j * cf;
        sm += cf;
      }
      elevated[0] = sm;

      // nearest remainder-0 point + rank
      float down = 1.0f / dp1;
      int sum = 0;
      for (int j = 0; j <= d; ++j) {
        float v = elevated[j] * down;
        int up = (int)std::ceil(v) * dp1;
        int dn = (int)std::floor(v) * dp1;
        rem0[j] = (up - elevated[j] < elevated[j] - dn) ? (float)up : (float)dn;
        sum += (int)rem0[j] / dp1;
      }
      for (int j = 0; j <= d; ++j) rank[j] = 0;
      for (int j = 0; j <= d; ++j) {
        float dj = elevated[j] - rem0[j];
        for (int k2 = j + 1; k2 <= d; ++k2) {
          float dk = elevated[k2] - rem0[k2];
          if (dj < dk)
            ++rank[j];
          else
            ++rank[k2];
        }
      }
      // fix points outside the canonical simplex
      for (int j = 0; j <= d; ++j) {
        rank[j] += sum;
        if (rank[j] < 0) {
          rank[j] += dp1;
          rem0[j] += dp1;
        } else if (rank[j] > d) {
          rank[j] -= dp1;
          rem0[j] -= dp1;
        }
      }
      // barycentric coordinates
      std::fill(barycentric.begin(), barycentric.end(), 0.f);
      for (int j = 0; j <= d; ++j) {
        float v = (elevated[j] - rem0[j]) * down;
        barycentric[d - rank[j]] += v;
        barycentric[d + 1 - rank[j]] -= v;
      }
      barycentric[0] += 1.0f + barycentric[dp1];

      // splat targets: the dp1 simplex corners
      for (int remainder = 0; remainder <= d; ++remainder) {
        for (int j = 0; j < d; ++j) {
          key[j] = (int)rem0[j] +
                   (rank[j] > d - remainder ? remainder - dp1 : remainder);
        }
        std::uint64_t h = hash_key(key.data());
        int id = find_key(h, key.data());
        if (id < 0) {
          id = (int)keys.size();
          hash.emplace(h, id);
          keys.emplace_back(key.begin(), key.end());
        }
        offsets_[(size_t)i * dp1 + remainder] = id;
        weights_[(size_t)i * dp1 + remainder] = barycentric[remainder];
      }
    }
    m_ = (int)keys.size();

    // precompute blur neighbors along each of the dp1 lattice directions
    blur_n1_.assign((size_t)(d + 1) * m_, -1);
    blur_n2_.assign((size_t)(d + 1) * m_, -1);
    std::vector<int> nk1(d), nk2(d);
    for (int dir = 0; dir <= d; ++dir) {
      for (int id = 0; id < m_; ++id) {
        const std::vector<int>& k0 = keys[id];
        for (int j = 0; j < d; ++j) {
          nk1[j] = k0[j] + 1;
          nk2[j] = k0[j] - 1;
        }
        if (dir < d) {
          nk1[dir] = k0[dir] - d;
          nk2[dir] = k0[dir] + d;
        }
        blur_n1_[(size_t)dir * m_ + id] = find_key(hash_key(nk1.data()), nk1.data());
        blur_n2_[(size_t)dir * m_ + id] = find_key(hash_key(nk2.data()), nk2.data());
      }
    }
  }

  // filter `vdim` channels: out = G * in  (in/out are [n, vdim] row-major)
  void compute(const float* in, float* out, int vdim) const {
    const int dp1 = d_ + 1;
    std::vector<float> values((size_t)(m_ + 2) * vdim, 0.f);
    std::vector<float> new_values((size_t)(m_ + 2) * vdim, 0.f);

    // splat
    for (int i = 0; i < n_; ++i) {
      for (int r = 0; r <= d_; ++r) {
        int o = offsets_[(size_t)i * dp1 + r] + 1;
        float w = weights_[(size_t)i * dp1 + r];
        for (int v = 0; v < vdim; ++v)
          values[(size_t)o * vdim + v] += w * in[(size_t)i * vdim + v];
      }
    }
    // blur along each direction: [1 2 1] / 2 (leave center ×2, as Adams et al.)
    for (int dir = 0; dir <= d_; ++dir) {
      for (int id = 0; id < m_; ++id) {
        int n1 = blur_n1_[(size_t)dir * m_ + id] + 1;
        int n2 = blur_n2_[(size_t)dir * m_ + id] + 1;
        const float* v0 = &values[(size_t)(id + 1) * vdim];
        const float* v1 = &values[(size_t)n1 * vdim];
        const float* v2 = &values[(size_t)n2 * vdim];
        float* nv = &new_values[(size_t)(id + 1) * vdim];
        for (int v = 0; v < vdim; ++v)
          nv[v] = v0[v] + 0.5f * (v1[v] + v2[v]);
      }
      std::swap(values, new_values);
    }
    // slice (alpha corrects the blur gain: 1 / (1 + 2^-d))
    const float alpha = 1.0f / (1.0f + std::pow(2.0f, -(float)d_));
    std::memset(out, 0, sizeof(float) * (size_t)n_ * vdim);
    for (int i = 0; i < n_; ++i) {
      for (int r = 0; r <= d_; ++r) {
        int o = offsets_[(size_t)i * dp1 + r] + 1;
        float w = weights_[(size_t)i * dp1 + r];
        for (int v = 0; v < vdim; ++v)
          out[(size_t)i * vdim + v] += w * values[(size_t)o * vdim + v] * alpha;
      }
    }
  }

 private:
  int d_ = 0, n_ = 0, m_ = 0;
  std::vector<int> offsets_;
  std::vector<float> weights_;
  std::vector<int> blur_n1_, blur_n2_;
};

// normalized filter: out_i = (G q)_i / (G 1)_i  (DenseCRF NORMALIZE_SYMMETRIC
// approximated by post-normalization, adequate for mean-field messages)
struct NormalizedFilter {
  Permutohedral lattice;
  std::vector<float> norm;

  void init(const float* features, int d, int n) {
    lattice.init(features, d, n);
    std::vector<float> ones((size_t)n, 1.0f);
    norm.assign((size_t)n, 0.f);
    lattice.compute(ones.data(), norm.data(), 1);
    for (int i = 0; i < n; ++i) norm[i] = 1.0f / std::max(norm[i], 1e-20f);
  }

  void apply(const float* in, float* out, int n, int vdim) const {
    lattice.compute(in, out, vdim);
    for (int i = 0; i < n; ++i)
      for (int v = 0; v < vdim; ++v) out[(size_t)i * vdim + v] *= norm[i];
  }
};

}  // namespace

extern "C" {

void dense_crf_inference(const float* unary_logits, const unsigned char* rgb,
                         int H, int W, int C, int iters, float pos_w,
                         float pos_xy_std, float bi_w, float bi_xy_std,
                         float bi_rgb_std, float* out_probs) {
  const int n = H * W;

  // --- build the two kernels' feature spaces -------------------------
  std::vector<float> feat_pos((size_t)n * 2), feat_bi((size_t)n * 5);
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int i = y * W + x;
      feat_pos[(size_t)i * 2 + 0] = (float)x / pos_xy_std;
      feat_pos[(size_t)i * 2 + 1] = (float)y / pos_xy_std;
      feat_bi[(size_t)i * 5 + 0] = (float)x / bi_xy_std;
      feat_bi[(size_t)i * 5 + 1] = (float)y / bi_xy_std;
      feat_bi[(size_t)i * 5 + 2] = (float)rgb[(size_t)i * 3 + 0] / bi_rgb_std;
      feat_bi[(size_t)i * 5 + 3] = (float)rgb[(size_t)i * 3 + 1] / bi_rgb_std;
      feat_bi[(size_t)i * 5 + 4] = (float)rgb[(size_t)i * 3 + 2] / bi_rgb_std;
    }
  }
  NormalizedFilter pos_filter, bi_filter;
  pos_filter.init(feat_pos.data(), 2, n);
  bi_filter.init(feat_bi.data(), 5, n);

  // --- mean field -----------------------------------------------------
  // unary_logits are class-major [C, n]; work pixel-major [n, C]
  std::vector<float> unary((size_t)n * C), Q((size_t)n * C),
      tmp((size_t)n * C), msg((size_t)n * C);
  for (int c = 0; c < C; ++c)
    for (int i = 0; i < n; ++i)
      unary[(size_t)i * C + c] = unary_logits[(size_t)c * n + i];

  auto softmax_rows = [&](std::vector<float>& src, std::vector<float>& dst) {
    for (int i = 0; i < n; ++i) {
      float mx = -1e30f;
      for (int c = 0; c < C; ++c) mx = std::max(mx, src[(size_t)i * C + c]);
      float s = 0.f;
      for (int c = 0; c < C; ++c) {
        float e = std::exp(src[(size_t)i * C + c] - mx);
        dst[(size_t)i * C + c] = e;
        s += e;
      }
      for (int c = 0; c < C; ++c) dst[(size_t)i * C + c] /= s;
    }
  };
  softmax_rows(unary, Q);

  for (int it = 0; it < iters; ++it) {
    // messages: w_m * (k_m*Q - Q)_i / (k_m*1)_i — the self-contribution
    // (kernel weight 1 at j==i) is removed in the UN-normalized sum, so it
    // subtracts as Q_i * norm_i after normalization
    pos_filter.apply(Q.data(), tmp.data(), n, C);
    for (int i = 0; i < n; ++i)
      for (int c = 0; c < C; ++c) {
        size_t idx = (size_t)i * C + c;
        msg[idx] = pos_w * (tmp[idx] - Q[idx] * pos_filter.norm[i]);
      }
    bi_filter.apply(Q.data(), tmp.data(), n, C);
    for (int i = 0; i < n; ++i)
      for (int c = 0; c < C; ++c) {
        size_t idx = (size_t)i * C + c;
        msg[idx] += bi_w * (tmp[idx] - Q[idx] * bi_filter.norm[i]);
      }
    // Potts compatibility: energy_i(l) = unary_i(l) + sum_{l'!=l} ... with
    // mu(l,l) = 0 → subtract the same-label message (attractive)
    for (size_t i = 0; i < (size_t)n * C; ++i) tmp[i] = unary[i] + msg[i];
    softmax_rows(tmp, Q);
  }

  for (int c = 0; c < C; ++c)
    for (int i = 0; i < n; ++i)
      out_probs[(size_t)c * n + i] = Q[(size_t)i * C + c];
}

// standalone Gaussian filter (exposed for tests)
void permutohedral_filter(const float* features, const float* values, int n,
                          int fdim, int vdim, float* out) {
  Permutohedral p;
  p.init(features, fdim, n);
  p.compute(values, out, vdim);
}

}  // extern "C"
