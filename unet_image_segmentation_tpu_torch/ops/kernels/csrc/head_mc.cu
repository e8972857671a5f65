// K11: the softmax segmentation head, NC = 2..4 classes, fused into the
// last decoder chain's exit (its sigmoid sibling K5 is head.cu).
//
// Replaces the TPU kernels unet_image_segmentation_tpu/ops/pallas/
// fused_head.py:_head_fwd_kernel_mc and _head_bwd_kernel_mc (launched by
// head_fwd_sums_mc and head_bwd_mc). Per pixel, with the head weights w
// (F, NC) and biases hb (NC,) rounded to T and class-id targets t:
//
//   z   = relu(a*y + b) -> T
//   l_c = T(T(Σ_f z_f w_fc) + hb_c);  p = softmax(l) in fp32 (max-subtracted
//         exp, normalised);  pred = the first class of maximal p
//   forward: per-sample fp32 sums I_c = Σ p_c [t=c], P_c = Σ p_c,
//            T_c = Σ [t=c], CCE = Σ -log(max(p_t, 1e-7)), CM[t][pred] += 1
//            (a target id >= NC counts in no class)
//   backward: dy_c = dI_c [t=c] + dP_c + dCCE (p_c >= eps ? -[t=c]/max(p_c, eps) : 0),
//             dl_c = p_c (dy_c - Σ_k p_k dy_k), dlb_c = T(dl_c),
//             dzt_f = (a y + b > 0) ? Σ_c dlb_c w_fc : 0   (written in T),
//             S = Σ dzt, T = Σ dzt (y - mean) rstd, dw_fc = Σ z_f dlb_c,
//             db_c = Σ dl_c (the unrounded dl).
//
// What bounds it on the H100: device memory, as K5's. At dec1 of the 512 px
// model at batch 8 (y 8x512x512x64, the elements of K5's 256 px batch 32)
// the forward reads y and the targets (270 MB in bf16, ~0.08 ms at 3.35
// TB/s) and the backward also writes dzt (~0.16 ms). Its arithmetic (about
// 2 NC + 6 fp32 operations an element forward, three times that backward,
// no contraction in the dots) is not far below that, so the instructions
// a byte count too.
//
// The first K11 split a pixel over a group of L lanes and left the softmax,
// the sums and dl to one lane of the group, on a grid fixed for a 132-SM
// card, each thread waiting on its own 16-byte loads, with a second launch
// for the row sums: 18% and 14% of its bound in bf16.
//
// Design: K5's streaming body (stream_sums.cuh, plan ops/fused_head.head_plan
// with nc): a CTA of 512 threads an SM walks runs of at most 512
// consecutive pixels of one sample through the 3-stage cp.async.bulk ring,
// writes one row of partial sums, and the last CTA sums the rows in row
// order inside the same launch.
// - Every lane computes a pixel: thread t owns pixel t of the run. Its
//   group of L lanes (the power of two at or above F/V) takes the group's L
//   pixels from the stage, lane g its 16-byte channel chunk of each, and a
//   transposing reduction (McDot::step, depth first, so log2(L) arrays of
//   NC partials live at once, not L) leaves lane g with pixel g's NC
//   logits. The softmax, argmax, CCE and the confusion-matrix row run in
//   every lane.
// - K11's arithmetic, not K5's: a lane sums its chunk's products in channel
//   order, each product and sum rounded on its own (no FMA), and the tree
//   pairs the lanes by the xor bits L/2, L/4, ..., 1, the butterfly that
//   the plain version's _group_dot (ops/fused_head.py) emulates. fp32
//   addition is commutative, so lane g's sum is the butterfly's bit for
//   bit: the logits, probabilities and argmax are the plain version's on the
//   card and the confusion matrix is exact (under 2^24 pixels a sample).
// - The forward keeps its lane's constants and its pixels' sums in
//   registers; T_c comes from the CM's rows when the sums of a sample are
//   flushed, once a sample.
// - The backward runs a run in two phases. (1) The forward's logits, then
//   dl and dlb of the owned pixel, dlb into shared memory. (2) A thread
//   takes 4 channels (chunk j = t mod F/4) of every (512 / (F/4))-th pixel,
//   recomputes a*y+b and z from the stage, writes dzt (8 or 16 bytes: a
//   group's stores of a pixel are one contiguous span) and adds to S, T and
//   dw of its channels. Both phases reload their channel constants from a
//   table in shared memory each run, so only the sums (S, T, dw: (2 + NC) 4
//   floats; db: NC) stay in registers across runs: at 16 warps a thread has
//   128 registers, and bf16 with NC = 4 needs 48 floats of constants for
//   phase 1 alone. The CTA sums its threads in a fixed order.
// - Two instances a direction, dtype and class count: the 64-channel group
//   of every config's dec1 with its tree unrolled, and one that takes its
//   lanes at run time for every other width (see mc_unrolled_lanes). A
//   kernel instance costs ptxas about half a second whatever its size, and
//   K11 is its own source so that it compiles beside K5.
// The ReLU mask is decided on a*y+b with separate roundings (affine_rn), as
// the plain version computes it; the softmax uses expf.

#include "head_common.cuh"

namespace unet {
namespace {

constexpr float kClipEps = 1e-7f;

template <int NC>
__host__ __device__ constexpr int mc_sums() { return 3 * NC + 1 + NC * NC; }

// Shared memory of K11's forward (which = 0) and backward (which = 1) with
// runs of `pixels`: the ring, or after it the block sums (last_cta_sums' 16
// bytes a thread; the backward's S, T and dw, (2 + NC) 16 bytes a thread);
// then the backward's table of constants (a, b, mean, rstd, w_c: (4 + NC) F
// floats; hb: 4) and the run's dlb (16 bytes a pixel).
template <typename T>
__host__ __device__ constexpr long long head_mc_main(int pixels, int F, int which, int NC) {
  return stream_smem(head_stage_bytes<T>(pixels, F),
                     (long long)kStreamThreads * 16 * (which ? 2 + NC : 1));
}

template <typename T>
__host__ __device__ constexpr long long head_mc_smem(int pixels, int F, int which, int NC) {
  return head_mc_main<T>(pixels, F, which, NC) +
         (which ? ((4LL + NC) * F + 4) * 4 + kStreamThreads * 16LL : 0LL);
}

// The checks of K11's plan (runs of at most one pixel a thread, ctas,
// smem) against the kernels' layout: cudaErrorInvalidValue for a plan they
// do not lay out so.
template <typename T>
int check_mc_plan(int B, int HW, int F, int pixels, int ctas, int smem, int which, int NC) {
  if (const int err = check_run_plan<T>(B, HW, F, pixels, ctas)) return err;
  return NC < 2 || NC > 4 || pixels > kStreamThreads ||
                 smem != head_mc_smem<T>(pixels, F, which, NC)
             ? (int)cudaErrorInvalidValue
             : 0;
}

__device__ __forceinline__ void unpack4(const float4 v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <int NC>
__device__ __forceinline__ void mc_softmax(const float (&l)[NC], float (&p)[NC]) {
  float m = l[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) m = fmaxf(m, l[c]);
  float e[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) e[c] = expf(__fsub_rn(l[c], m));
  float s = e[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) s = __fadd_rn(s, e[c]);
#pragma unroll
  for (int c = 0; c < NC; ++c) p[c] = __fdiv_rn(e[c], s);
}

// the first class whose probability is maximal
template <int NC>
__device__ __forceinline__ int mc_argmax(const float (&p)[NC]) {
  float m = p[0];
#pragma unroll
  for (int c = 1; c < NC; ++c) m = fmaxf(m, p[c]);
  int pred = NC - 1;
#pragma unroll
  for (int c = NC - 1; c >= 0; --c)
    if (p[c] == m) pred = c;
  return pred;
}

// K11's group of lanes at 64 channels, the dec1 width of every config (8
// lanes in bf16, 16 in fp32): the one count with an instance of its own,
// whose tree is unrolled. Every other width takes its lanes at run time and
// walks the leaves of its tree in a loop (LT = 0); one instance a count
// would cost each direction, dtype and class count a compile of its own.
template <typename T>
__host__ __device__ constexpr int mc_unrolled_lanes() { return 64 / head_vec<T>(); }

__host__ __device__ constexpr int ilog2(int n) { return n > 1 ? 1 + ilog2(n / 2) : 0; }

// A lane's share of K11's logits: its channel chunk's constants (V
// channels, lane g of a group of L; LT = L, or 0 for L at run time) and the
// transposing reduction that leaves lane g with the NC dots of the group's
// pixel g. Unrolled, the chunk's affine a, b and head weights stay in
// registers; at run time the loop's registers are short, so the affine is
// read at each leaf, and with 4 classes the weights too.
template <typename T, int LT, int NC>
struct McDot {
  static constexpr int V = head_vec<T>();
  static constexpr bool kAffInRegs = LT > 0, kWInRegs = LT > 0 || NC < 4;
  float a[kAffInRegs ? V : 1], sh[kAffInRegs ? V : 1], w[kWInRegs ? NC : 1][V];
  const float4 *a4, *sh4;  // a and b, F / 4 quads of channels each
  const float4* w4;        // w (F, 4) in device memory, a quad a channel

  // a4, sh4: the rows a and b (device or shared memory); the weights from
  // wq, F / 4 quads for each class (kTable: the backward's table), or from
  // wg, w (F, NC) in device memory, which is also where the leaves read them
  // when they are not kept
  template <bool kTable>
  __device__ void load(const float4* a4_, const float4* sh4_, const float4* wq, const float* wg,
                       int F, int lane) {
    a4 = a4_;
    sh4 = sh4_;
    w4 = reinterpret_cast<const float4*>(wg);
    const int F4 = F / 4;
    const bool act = lane < F / V;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const int q = lane * (V / 4) + k;
      if constexpr (kAffInRegs) {
        unpack4(act ? a4[q] : zero, a + 4 * k);
        unpack4(act ? sh4[q] : zero, sh + 4 * k);
      }
      if constexpr (kWInRegs) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if constexpr (kTable) {
            unpack4(act ? wq[c * F4 + q] : zero, w[c] + 4 * k);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) w[c][4 * k + e] = act ? wg[(4 * q + e) * NC + c] : 0.f;
          }
        }
      }
    }
  }

  // the lane's chunk of pixel px (of the run's np) in the stage ys: the NC
  // products summed in channel order; 0 past the run or the channels
  __device__ __forceinline__ void leaf(const T* ys, int F, int px, int np, int lane,
                                       float (&d)[NC]) const {
    if (lane < F / V && px < np) {
      float yv[V], av[V], sv[V];
      load_vec<T, V>(ys + (size_t)px * F + lane * V, yv);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        if constexpr (kAffInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            av[4 * k + e] = a[4 * k + e];
            sv[4 * k + e] = sh[4 * k + e];
          }
        } else {
          unpack4(a4[lane * (V / 4) + k], av + 4 * k);
          unpack4(sh4[lane * (V / 4) + k], sv + 4 * k);
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float z = round_to<T>(fmaxf(affine_rn(yv[j], av[j], sv[j]), 0.f));
        float wj[NC];
        if constexpr (kWInRegs) {
#pragma unroll
          for (int c = 0; c < NC; ++c) wj[c] = w[c][j];
        } else {
          unpack4(w4[lane * V + j], wj);
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
          d[c] = j ? __fadd_rn(d[c], __fmul_rn(z, wj[c])) : __fmul_rn(z, wj[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) d[c] = 0.f;
    }
  }

  // Leaf k of n = 2^D in the tree's depth-first order, then the rounds it
  // completes. GroupDots' rounds pair index I with I + OFF (OFF = n/2, then
  // n/4, ...; each lane keeps the pixels whose OFF bit is its own);
  // evaluated depth first, the leaves come in bit-reversed order and leaf k
  // closes one round for each trailing 1 bit of k, level j's with OFF = n
  // >> (j + 1). So log2(n) partial arrays of NC live at once (s), not n.
  __device__ __forceinline__ void step(const T* ys, int F, int pb, int np, int lane, int n,
                                       int D, int k, float (&s)[5][NC], float (&d)[NC]) const {
    leaf(ys, F, pb + (D ? (int)(__brev((unsigned)k) >> (32 - D)) : 0), np, lane, d);
    bool carry = true;  // no break: every s[j] keeps a constant index
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (carry && j < D) {
        if ((k >> j) & 1) {
          const int off = n >> (j + 1);
          const bool upper = lane & off;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float send = upper ? s[j][c] : d[c];
            const float keep = upper ? d[c] : s[j][c];
            d[c] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, off));
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) s[j][c] = d[c];
          carry = false;
        }
      }
    }
  }

  // the logits of pixel pb + lane (pb: the group's first pixel; n: its
  // lanes, LT unless LT is 0); hb the NC biases
  __device__ __forceinline__ void logits(const T* ys, int F, int pb, int np, int lane, int n,
                                         const float* hb, float (&l)[NC]) const {
    float s[5][NC], d[NC];
    if constexpr (LT > 0) {
      static_assert(LT <= 32 && (1 << ilog2(LT)) == LT, "a group of a warp");
#pragma unroll
      for (int k = 0; k < LT; ++k) step(ys, F, pb, np, lane, LT, ilog2(LT), k, s, d);
    } else {
      const int D = 31 - __clz(n);
#pragma unroll 1
      for (int k = 0; k < n; ++k) step(ys, F, pb, np, lane, n, D, k, s, d);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) l[c] = round_to<T>(__fadd_rn(round_to<T>(d[c]), hb[c]));
  }
};

template <typename T, int LT, int NC>
struct McFwdOp : RunSpan<T> {
  static constexpr int NS = mc_sums<NC>();
  McDot<T, LT, NC> dot;
  float hb[NC];
  float ip[NC], pp[NC], cce, cm[NC][NC];  // the owned pixels' sums of sample cur
  int lanes, cur;
  float* row;  // this CTA's partial row, (B, NS)
  float (*wred)[NS];

  // the CTA's sums of sample cur into its row, in the order I | P | T | CCE
  // | CM (T_c: CM row c, exact counts); every thread calls it
  __device__ void flush() {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      float v;
      if (k < NC) {
        v = ip[k];
      } else if (k < 2 * NC) {
        v = pp[k - NC];
      } else if (k < 3 * NC) {
        v = cm[k - 2 * NC][0];
#pragma unroll
        for (int j = 1; j < NC; ++j) v += cm[k - 2 * NC][j];
      } else if (k == 3 * NC) {
        v = cce;
      } else {
        v = cm[(k - 3 * NC - 1) / NC][(k - 3 * NC - 1) % NC];
      }
      v = warp_sum(v);
      if (threadIdx.x % 32 == 0) wred[threadIdx.x / 32][k] = v;
    }
    clear();
    __syncthreads();
    if (threadIdx.x < NS) {
      float acc = 0.f;
      for (int wp = 0; wp < kStreamThreads / 32; ++wp) acc += wred[wp][threadIdx.x];
      row[cur * NS + threadIdx.x] = acc;
    }
    __syncthreads();
  }

  __device__ void clear() {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      ip[c] = pp[c] = 0.f;
#pragma unroll
      for (int k = 0; k < NC; ++k) cm[c][k] = 0.f;
    }
    cce = 0.f;
  }

  __device__ void consume(long long unit, const char* stage) {
    int b, np;
    size_t q0;
    this->place(unit, b, q0, np);
    if (b != cur) {
      if (cur >= 0) flush();
      cur = b;
    }
    const int px = threadIdx.x, n = LT ? LT : lanes;
    if ((px & ~31) >= np) return;  // the warp's 32 pixels lie past the run
    float l[NC];
    dot.logits(this->stage_y(stage), this->F, px & ~(n - 1), np, px & (n - 1), n, hb, l);
    if (px >= np) return;
    float p[NC];
    mc_softmax<NC>(l, p);
    const int pred = mc_argmax<NC>(p);
    const int t = this->stage_t(stage, q0)[px];
    float pt = 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const bool tc = t == c;
      pp[c] += p[c];
      ip[c] += tc ? p[c] : 0.f;
      pt = tc ? p[c] : pt;
#pragma unroll
      for (int k = 0; k < NC; ++k) cm[c][k] += tc && pred == k ? 1.f : 0.f;
    }
    if (t < NC) cce -= logf(fmaxf(pt, kClipEps));
  }
};

// partials[blockIdx.x]: the CTA's (B, NS) sums (ld floats a row); the last
// CTA to arrive sums the rows into sums (B, NS).
template <typename T, int LT, int NC>
__global__ void __launch_bounds__(kStreamThreads, 1)
    head_fwd_mc_kernel(const T* __restrict__ y, const uint8_t* __restrict__ tgt,
                       const float* __restrict__ aff, const float* __restrict__ w,
                       const float* __restrict__ hb, float* __restrict__ partials,
                       float* __restrict__ sums, unsigned* counter, int B, int HW, int F,
                       int lanes, int pixels, int ld) {
  extern __shared__ __align__(128) char smem[];
  constexpr int NS = mc_sums<NC>();
  __shared__ float wred[kStreamThreads / 32][NS];
  McFwdOp<T, LT, NC> op;
  op.init(y, tgt, B, HW, F, pixels);
  op.lanes = lanes;
  op.dot.template load<false>(reinterpret_cast<const float4*>(aff),
                              reinterpret_cast<const float4*>(aff + F), nullptr, w, F,
                              threadIdx.x % lanes);
#pragma unroll
  for (int c = 0; c < NC; ++c) op.hb[c] = hb[c];
  op.clear();
  op.cur = -1;
  op.row = partials + (size_t)blockIdx.x * ld;
  op.wred = wred;
  for (int c = threadIdx.x; c < ld; c += kStreamThreads) op.row[c] = 0.f;  // samples not taken
  long long begin, end;
  unit_range((long long)B * op.runs, gridDim.x, blockIdx.x, begin, end);
  stream_units(op, smem, head_stage_bytes<T>(pixels, F), begin, end);
  if (op.cur >= 0) op.flush();
  last_cta_sums(partials, ld, B * NS, sums, counter,
                reinterpret_cast<float4*>(smem + kStreamBarBytes));
}

template <typename T, int LT, int NC>
struct McBwdOp : RunSpan<T> {
  const float4* tab;  // a | b | mean | rstd | w_0 .. w_{NC-1}: F / 4 quads each; hb
  const float* w;     // (F, NC) in device memory
  const float* gsc;
  float4* dls;        // the run's dlb, a pixel's NC in 4 floats
  T* dzt;
  int lanes;
  float st[4], tt[4], dw[NC][4], db[NC];

  // phase 1: the owned pixel's dl; dlb into dls
  __device__ void pixel_dl(const char* stage, size_t q0, int b, int np) {
    const int px = threadIdx.x, n = LT ? LT : lanes;
    float l[NC];
    {
      const int F4 = this->F / 4;
      McDot<T, LT, NC> dot;
      dot.template load<true>(tab, tab + F4, tab + 4 * F4, dot.kWInRegs ? nullptr : w, this->F,
                              px & (n - 1));
      dot.logits(this->stage_y(stage), this->F, px & ~(n - 1), np, px & (n - 1), n,
                 reinterpret_cast<const float*>(tab + (4 + NC) * (this->F / 4)), l);
    }
    if (px >= np) return;
    float p[NC], dy[NC];
    mc_softmax<NC>(l, p);
    const int t = this->stage_t(stage, q0)[px];
    const float* g = gsc + b * (2 * NC + 1);
    const float gc = g[2 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float tc = c == t ? 1.f : 0.f;
      const float q = p[c] >= kClipEps ? __fdiv_rn(-tc, fmaxf(p[c], kClipEps)) : 0.f;
      dy[c] = __fadd_rn(__fadd_rn(__fmul_rn(g[c], tc), g[NC + c]), __fmul_rn(gc, q));
    }
    float ydot = __fmul_rn(p[0], dy[0]);
#pragma unroll
    for (int c = 1; c < NC; ++c) ydot = __fadd_rn(ydot, __fmul_rn(p[c], dy[c]));
    float dlb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float dl = __fmul_rn(p[c], __fsub_rn(dy[c], ydot));
      dlb[c] = round_to<T>(dl);
      db[c] += dl;
    }
    dls[px] = make_float4(dlb[0], dlb[1], dlb[2], dlb[3]);
  }

  // phase 2: the thread's 4 channels (chunk j = t mod F/4) of every
  // slots-th pixel of the run (slots = 512 / (F/4), from t / (F/4))
  __device__ void channels(const char* stage, size_t q0, int np) {
    const int F = this->F, F4 = F / 4, chunk = threadIdx.x % F4, slots = kStreamThreads / F4;
    const int slot = threadIdx.x / F4, f0 = chunk * 4;
    if (slot >= slots) return;
    float a[4], sh[4], mean[4], rstd[4], wv[NC][4];
    unpack4(tab[chunk], a);
    unpack4(tab[F4 + chunk], sh);
    unpack4(tab[2 * F4 + chunk], mean);
    unpack4(tab[3 * F4 + chunk], rstd);
#pragma unroll
    for (int c = 0; c < NC; ++c) unpack4(tab[(4 + c) * F4 + chunk], wv[c]);
    const T* ys = this->stage_y(stage);
    for (int p = slot; p < np; p += slots) {
      float dl[4], yv[4], d[4];
      unpack4(dls[p], dl);
      load_vec<T, 4>(ys + (size_t)p * F + f0, yv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float wl = affine_rn(yv[e], a[e], sh[e]);
        const float z = round_to<T>(fmaxf(wl, 0.f));
        float v = __fmul_rn(dl[0], wv[0][e]);
#pragma unroll
        for (int c = 1; c < NC; ++c) v = __fadd_rn(v, __fmul_rn(dl[c], wv[c][e]));
        d[e] = wl > 0.f ? v : 0.f;
        st[e] += d[e];
        tt[e] += d[e] * ((yv[e] - mean[e]) * rstd[e]);
#pragma unroll
        for (int c = 0; c < NC; ++c) dw[c][e] += z * dl[c];
      }
      store_vec<T, 4>(dzt + (q0 + p) * F + f0, d);
    }
  }

  __device__ void consume(long long unit, const char* stage) {
    int b, np;
    size_t q0;
    this->place(unit, b, q0, np);
    if ((int)(threadIdx.x & ~31u) < np) pixel_dl(stage, q0, b, np);
    __syncthreads();  // the run's dlb are in dls
    channels(stage, q0, np);
  }
};

// partials[blockIdx.x]: the CTA's S (F) | T (F) | dw (F x NC) | db (NC), ld
// floats a row; the last CTA to arrive sums the rows into out.
template <typename T, int LT, int NC>
__global__ void __launch_bounds__(kStreamThreads, 1)
    head_bwd_mc_kernel(const T* __restrict__ y, const uint8_t* __restrict__ tgt,
                       const float* __restrict__ aff4, const float* __restrict__ w,
                       const float* __restrict__ hb, const float* __restrict__ gsc,
                       T* __restrict__ dzt, float* __restrict__ partials,
                       float* __restrict__ out, unsigned* counter, int B, int HW, int F,
                       int lanes, int pixels, int ld) {
  extern __shared__ __align__(128) char smem[];
  __shared__ float wred[kStreamThreads / 32][NC];
  constexpr int R = (2 + NC) * 4;  // floats of block sums a thread
  float* tabf = reinterpret_cast<float*>(smem + head_mc_main<T>(pixels, F, 1, NC));
  for (int i = threadIdx.x; i < (4 + NC) * F + 4; i += kStreamThreads) {
    const int kind = i / F, f = i % F;
    tabf[i] = kind < 4 ? aff4[kind * F + f]
              : kind < 4 + NC ? w[f * NC + kind - 4]
              : f < NC ? hb[f] : 0.f;
  }
  __syncthreads();
  McBwdOp<T, LT, NC> op;
  op.init(y, tgt, B, HW, F, pixels);
  op.tab = reinterpret_cast<const float4*>(tabf);
  op.w = w;
  op.gsc = gsc;
  op.dls = reinterpret_cast<float4*>(tabf + (4 + NC) * F + 4);
  op.dzt = dzt;
  op.lanes = lanes;
  const int C4 = F / 4, slots = kStreamThreads / C4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    op.st[e] = op.tt[e] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) op.dw[c][e] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) op.db[c] = 0.f;
  long long begin, end;
  unit_range((long long)B * op.runs, gridDim.x, blockIdx.x, begin, end);
  stream_units(op, smem, head_stage_bytes<T>(pixels, F), begin, end);

  // the CTA's S, T, dw: channel f sums the slots that hold it, in slot
  // order; db over the warps in order
  float* red = reinterpret_cast<float*>(smem + kStreamBarBytes);
  float* mine = red + (size_t)threadIdx.x * R;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    mine[e] = op.st[e];
    mine[4 + e] = op.tt[e];
#pragma unroll
    for (int c = 0; c < NC; ++c) mine[(2 + c) * 4 + e] = op.dw[c][e];
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const float v = warp_sum(op.db[c]);
    if (threadIdx.x % 32 == 0) wred[threadIdx.x / 32][c] = v;
  }
  __syncthreads();
  float* row = partials + (size_t)blockIdx.x * ld;
  for (int col = threadIdx.x; col < (2 + NC) * F; col += kStreamThreads) {
    const bool st_t = col < 2 * F;
    const int f = st_t ? col % F : (col - 2 * F) / NC;
    const int part = st_t ? col / F : 2 + (col - 2 * F) % NC;
    const float* src = red + (f / 4) * R + part * 4 + f % 4;
    float acc = 0.f;
    for (int s = 0; s < slots; ++s) acc += src[(size_t)s * C4 * R];
    row[col] = acc;
  }
  if (threadIdx.x < NC) {
    float acc = 0.f;
    for (int wp = 0; wp < kStreamThreads / 32; ++wp) acc += wred[wp][threadIdx.x];
    row[(2 + NC) * F + threadIdx.x] = acc;
  }
  last_cta_sums(partials, ld, (2 + NC) * F + NC, out, counter,
                reinterpret_cast<float4*>(smem + kStreamBarBytes));
}

template <typename T, int NC>
int fwd_mc_nc(const void* y, const void* tgt, const void* aff, const void* w, const void* hb,
              float* work, float* sums, unsigned* counter, int B, int HW, int F, int pixels,
              int ctas, int smem, cudaStream_t s) {
  constexpr int U = mc_unrolled_lanes<T>();
  const int L = group_lanes(F, (int)sizeof(T));
  const int ld = (int)round_up((long long)B * mc_sums<NC>(), 4);
  return launch_stream(L == U ? head_fwd_mc_kernel<T, U, NC> : head_fwd_mc_kernel<T, 0, NC>, ctas,
                       smem, s, static_cast<const T*>(y), static_cast<const uint8_t*>(tgt),
                       static_cast<const float*>(aff), static_cast<const float*>(w),
                       static_cast<const float*>(hb), work, sums, counter, B, HW, F, L, pixels,
                       ld);
}

template <typename T, int NC>
int bwd_mc_nc(const void* y, const void* tgt, const void* aff4, const void* w, const void* hb,
              const void* gsc, void* dzt, float* work, float* out, unsigned* counter, int B,
              int HW, int F, int pixels, int ctas, int smem, cudaStream_t s) {
  constexpr int U = mc_unrolled_lanes<T>();
  const int L = group_lanes(F, (int)sizeof(T));
  const int ld = (int)round_up((2LL + NC) * F + NC, 4);
  return launch_stream(L == U ? head_bwd_mc_kernel<T, U, NC> : head_bwd_mc_kernel<T, 0, NC>, ctas,
                       smem, s, static_cast<const T*>(y), static_cast<const uint8_t*>(tgt),
                       static_cast<const float*>(aff4), static_cast<const float*>(w),
                       static_cast<const float*>(hb), static_cast<const float*>(gsc),
                       static_cast<T*>(dzt), work, out, counter, B, HW, F, L, pixels, ld);
}

template <typename T>
int fwd_mc(int NC, const void* y, const void* tgt, const void* aff, const void* w, const void* hb,
           float* work, float* sums, unsigned* counter, int B, int HW, int F, int pixels,
           int ctas, int smem, cudaStream_t s) {
  if (const int err = check_mc_plan<T>(B, HW, F, pixels, ctas, smem, 0, NC)) return err;
  switch (NC) {
#define UNET_FWD_MC(NC)                                                                     \
  case NC:                                                                                \
    return fwd_mc_nc<T, NC>(y, tgt, aff, w, hb, work, sums, counter, B, HW, F, pixels, ctas, \
                            smem, s);
    UNET_FWD_MC(2)
    UNET_FWD_MC(3)
    UNET_FWD_MC(4)
#undef UNET_FWD_MC
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_mc(int NC, const void* y, const void* tgt, const void* aff4, const void* w,
           const void* hb, const void* gsc, void* dzt, float* work, float* out,
           unsigned* counter, int B, int HW, int F, int pixels, int ctas, int smem,
           cudaStream_t s) {
  if (const int err = check_mc_plan<T>(B, HW, F, pixels, ctas, smem, 1, NC)) return err;
  switch (NC) {
#define UNET_BWD_MC(NC)                                                                     \
  case NC:                                                                                \
    return bwd_mc_nc<T, NC>(y, tgt, aff4, w, hb, gsc, dzt, work, out, counter, B, HW, F,   \
                            pixels, ctas, smem, s);
    UNET_BWD_MC(2)
    UNET_BWD_MC(3)
    UNET_BWD_MC(4)
#undef UNET_BWD_MC
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace unet

// K11 forward. y (B,H,W,F) in T, HW = H*W, 16-byte aligned; tgt (B,H,W)
// uint8 class ids; aff (2,F) fp32 = a, b; w (F,NC) and hb (NC,) fp32,
// rounded to T; sums (B, 3NC+1+NC*NC) fp32 = I | P | T | CCE | CM; NC in
// 2..4; work (ctas, round_up(B (3NC+1+NC*NC), 4)) fp32 rows; counter an
// unsigned int that is 0 and is left 0; the plan of
// ops/fused_head.head_plan(..., nc): runs of `pixels`, ctas, smem bytes.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the
// kernel does not lay out so.
extern "C" int unet_head_fwd_mc(const void* y, const void* tgt, const void* aff, const void* w,
                                const void* hb, void* work, void* sums, void* counter, int B,
                                int HW, int F, int NC, int pixels, int ctas, int smem, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(sums);
  unsigned* c = static_cast<unsigned*>(counter);
  if (dtype == 0)
    return unet::fwd_mc<float>(NC, y, tgt, aff, w, hb, wk, o, c, B, HW, F, pixels, ctas, smem, s);
  if (dtype == 1)
    return unet::fwd_mc<__nv_bfloat16>(NC, y, tgt, aff, w, hb, wk, o, c, B, HW, F, pixels, ctas,
                                       smem, s);
  return (int)cudaErrorInvalidValue;
}

// K11 backward: as unet_head_fwd_mc, plus aff4 (4,F) fp32 = a, b, mean,
// rstd; gsc (B, 2NC+1) fp32 = dI (NC) | dP (NC) | dCCE; dzt (B,H,W,F) in T;
// out ((2+NC)F + NC) fp32 = S | T | dw (F,NC) | db (NC); work (ctas,
// round_up((2+NC)F + NC, 4)) fp32 rows. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel does not lay out so.
extern "C" int unet_head_bwd_mc(const void* y, const void* tgt, const void* aff4, const void* w,
                                const void* hb, const void* gsc, void* dzt, void* work, void* out,
                                void* counter, int B, int HW, int F, int NC, int pixels, int ctas,
                                int smem, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  float* o = static_cast<float*>(out);
  unsigned* c = static_cast<unsigned*>(counter);
  if (dtype == 0)
    return unet::bwd_mc<float>(NC, y, tgt, aff4, w, hb, gsc, dzt, wk, o, c, B, HW, F, pixels,
                               ctas, smem, s);
  if (dtype == 1)
    return unet::bwd_mc<__nv_bfloat16>(NC, y, tgt, aff4, w, hb, gsc, dzt, wk, o, c, B, HW, F,
                                       pixels, ctas, smem, s);
  return (int)cudaErrorInvalidValue;
}
