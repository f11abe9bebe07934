// Kernel K2 of the port: the fused concat-trick edge layer's backward, as
// three kernels that fused_edge_bwd.cu launches in turn (the math, with
// every rounding point, is edge_bwd.cuh's: the chain recomputed, the
// LayerNorm backward in fp32, the cotangent run back through the stack).
//
//  1. edge_rows_kernel: each warp owns 16 rows of a 128-row chunk and runs
//     the whole chain for them with no CTA barrier: the forward recompute
//     (e @ W_e + sg + mask * d_proj[recv], the hidden stack, W_out), the
//     LayerNorm backward and the backward products, writing d_e and d_sg
//     and, for the weight gradients, the post-ReLU activations a(0..nh)
//     and the cotangents dz(1..nh), d_d to a workspace. In bf16 the
//     activation between two products never leaves registers: the mma
//     accumulator of one product, rounded and packed in pairs, is the A
//     fragment of the next (the m16n8 accumulator layout is the k16 A
//     layout), and the ReLU masks are kept as bits. fp32 (FFMA, no TF32)
//     stages each product's A operand in a warp-private slice of shared
//     memory. Weights: in bf16 one copy of each, the forward product
//     reading it with ldmatrix and the backward one (dz @ W^T) with
//     ldmatrix.trans from the same tile; in fp32 W and W^T, so both FFMA
//     products stream B as float2 rows. All resident for the CTA's life
//     where they fit (the bf16 flagship: 4 x 34.8 KB), else (fp32 at h =
//     128) a ring of two slots in the product order, the next weight's
//     cp.async copy overlapping the current product, one CTA barrier per
//     product. The LayerNorm column sums (dscale, dbias)
//     accumulate per warp in shared memory over all of the CTA's chunks.
//  2. fill_pad_rows (pad tiles' d_e and d_sg, kFillSplit CTAs a tile),
//     then d_dproj, the segmented row sum of
//     mask * d_sg by receiver, on K7's lane-group schedule
//     (segment_rows.cuh, the pad sink declared).
//  3. edge_dw_kernel: dW = A^T dZ for the nh + 2 pairs (e, d_sg), (a(i),
//     dz(i + 1)), (a(nh), d_d), and the bias gradients as column sums of
//     dZ, split over the rows: CTA (s, p) sums pair p over the chunks s, s
//     + grid, ... in 64-row slabs that cp.async double-buffers, mma.sync on
//     fragments ldmatrix.trans loads (bf16) or FFMA (fp32), its fp32
//     accumulator in registers for the CTA's whole range, written once.
//  4. reduce_partials (chain_bwd.cuh) sums the per-split partials in split
//     order. No float atomics anywhere: the same inputs give the same bits.
//
// Pad tiles (chain.cuh first_pad_tile: a tile whose first row is masked)
// are skipped by kernels 1 and 3 and filled by fill_pad_rows (d_e = ct_e,
// d_sg = 0), the VJP wherever the cotangent of pad rows is zero, as on the
// training path. The workspace ([grid] partials, then a(0..nh) and
// dz(1..nh), d_d, each [E][H] of T, then d_dproj's row pointer) is planned
// in Python
// (ops/hopper_fused.py edge_bwd_plan) and checked here.
#pragma once

#include "chain_bwd.cuh"
#include "segment_rows.cuh"

namespace chain {

constexpr int kMaxHidden = 8;  // ReLU-mask words kept per warp row pair
constexpr int kSlab = 64;      // rows per weight-gradient slab

template <typename T>
struct RowsBwdArgs {
  const T *e, *sg, *d_proj, *mask;
  const int* recv;
  // W_e, ws[0..nh), W_out as the products read their B operand
  // (ops/_build.py edge_bwd_operands): bf16 [n_hidden + 2][H][H]
  // transposed ([n][k]), fp32 [n_hidden + 2][2][H][H] (W and W^T, [k][n])
  const T *wb, *bs, *b_out, *ln_scale, *ct_e, *ct_agg;
  T *d_e, *d_sg, *d_dproj;
  T *acts, *cots;  // workspace: a(0..nh), and dz(1..nh) then d_d
  float* part;     // workspace: [grid][part_len]
  int* offsets;    // workspace: the receiver stream's row pointer [N + 1]
  int64_t n_edges, part_len;
  int n_nodes, n_hidden, edge_tile, n_chunks;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8q..8q+7 give the row
// addresses of matrix q; lane (g, t) receives its elements [g][2t] and
// [g][2t+1] in register q.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// An [H, H] matrix of device memory (row-major) into a padded shared tile
// by cp.async, 16 bytes per copy; the caller commits and waits.
template <typename T, int H>
__device__ __forceinline__ void copy_mat_async(T* dst,
                                               const T* __restrict__ src) {
  constexpr int LD = Layout<T, H>::kLd;
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = H / V;
  for (int i = threadIdx.x; i < H * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * V;
    cp_async16(dst + r * LD + c, src + size_t(r) * H + c);
  }
}

// The weight copies the products read: bf16 one per matrix (the backward
// product reads it transposed with ldmatrix.trans), fp32 two (W, then
// W^T, both [k][n], so that both products stream B as float2 rows).
template <typename T>
constexpr int kCopies = sizeof(T) == 4 ? 2 : 1;

// The stored matrix of product p of a chunk's 2 (nh + 2): the forward W_e,
// ws[0], ..., W_out (0 .. nh + 1), then the backward W_out, ws[nh - 1],
// ..., W_e (with fp32, their transposed copies).
template <typename T>
__device__ __forceinline__ int mat_of(int p, int nh) {
  const bool bwd = p >= nh + 2;
  const int m = bwd ? 2 * nh + 3 - p : p;
  return kCopies<T> == 2 ? 2 * m + bwd : m;
}

// The weights in shared memory: all resident, or a ring of two slots
// through which the products' weights stream in order (cp.async one product
// ahead; every thread of the CTA calls get() for every product).
template <typename T, int H>
struct WeightRing {
  static constexpr size_t kMat = size_t(H) * Layout<T, H>::kLd;
  T* slots;
  const T* wb;
  int resident, nh, n_prod, s;

  __device__ void start() {
    if (resident) {
      for (int m = 0; m < (nh + 2) * kCopies<T>; ++m)
        copy_mat_async<T, H>(slots + m * kMat, wb + size_t(m) * H * H);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    } else {
      copy_mat_async<T, H>(slots, wb);  // product 0: W_e
      cp_async_commit();
    }
  }
  __device__ const T* get(int p) {
    if (resident) return slots + mat_of<T>(p, nh) * kMat;
    cp_async_wait<0>();
    __syncthreads();  // the copy is visible; product s - 1 is done
    const int m_next = mat_of<T>((p + 1) % n_prod, nh);
    copy_mat_async<T, H>(slots + ((s + 1) & 1) * kMat,
                         wb + size_t(m_next) * H * H);
    cp_async_commit();
    return slots + ((s++) & 1) * kMat;
  }
  __device__ void finish() {
    if (!resident) cp_async_wait<0>();
  }
};

// A product's A operand: the warp's 16 rows of an activation.
template <typename T, int H>
struct RowOperand;

// bf16: in registers as mma A fragments, [k block][4].
template <int H>
struct RowOperand<__nv_bfloat16, H> {
  using T = __nv_bfloat16;
  static constexpr int LD = Layout<T, H>::kLd;
  uint32_t f[H / 16][4];

  __device__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&b);
  }
  // rows ra / rb (the thread's rows g and g + 8) of device memory
  __device__ void from_rows(const T* row_a, const T* row_b, T*) {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int kb = 0; kb < H / 16; ++kb) {
      const int c = 16 * kb + 2 * t;
      f[kb][0] = *reinterpret_cast<const uint32_t*>(row_a + c);
      f[kb][1] = *reinterpret_cast<const uint32_t*>(row_b + c);
      f[kb][2] = *reinterpret_cast<const uint32_t*>(row_a + c + 8);
      f[kb][3] = *reinterpret_cast<const uint32_t*>(row_b + c + 8);
    }
  }
  // an accumulator of already rounded values: n-tiles 2kb and 2kb + 1 are
  // k block kb
  __device__ void from_acc(const float (&v)[H / 8][4], T*) {
#pragma unroll
    for (int kb = 0; kb < H / 16; ++kb) {
      f[kb][0] = pack(v[2 * kb][0], v[2 * kb][1]);
      f[kb][1] = pack(v[2 * kb][2], v[2 * kb][3]);
      f[kb][2] = pack(v[2 * kb + 1][0], v[2 * kb + 1][1]);
      f[kb][3] = pack(v[2 * kb + 1][2], v[2 * kb + 1][3]);
    }
  }
  // acc += A @ B: kTrans false reads B = W from the [n][k] tile (ldmatrix),
  // true reads B = W^T from the same tile, [k][n] (ldmatrix.trans)
  template <bool kTrans>
  __device__ void mm(const T* w, float (&acc)[H / 8][4], T*) const {
    const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int kb = 0; kb < H / 16; ++kb) {
#pragma unroll
      for (int j = 0; j < H / 8; j += 2) {
        uint32_t b[4];
        if constexpr (kTrans)
          ldsm_x4_trans(b, w + (16 * kb + (q & 1) * 8 + r8) * LD +
                               8 * (j + (q >> 1)));
        else
          ldsm_x4(b, w + (8 * (j + (q >> 1)) + r8) * LD + 16 * kb +
                         (q & 1) * 8);
        mma_bf16(acc[j], f[kb], b[0], b[1]);
        mma_bf16(acc[j + 1], f[kb], b[2], b[3]);
      }
    }
  }
};

// fp32: staged in the warp's [16][LD] slice of shared memory.
template <int H>
struct RowOperand<float, H> {
  static constexpr int LD = Layout<float, H>::kLd;

  __device__ void from_rows(const float* row_a, const float* row_b,
                            float* stg) {
    float v[H / 8][4];
    load_acc<float, H>(v, row_a, row_b);
    from_acc(v, stg);
  }
  __device__ void from_acc(const float (&v)[H / 8][4], float* stg) {
    const int g = (threadIdx.x & 31) >> 2;
    __syncwarp();  // the previous product has read the slice
    store_acc<float, H>(v, stg + g * LD, stg + (g + 8) * LD);
    __syncwarp();
  }
  // acc += A @ B, B the [k][n] tile of W or of W^T (chain.cuh mm)
  template <bool kTrans>
  __device__ void mm(const float* w, float (&acc)[H / 8][4],
                     float* stg) const {
    chain::mm<H>(stg, w, acc);
  }
};

template <int H>
__device__ __forceinline__ uint64_t relu_bits(const float (&acc)[H / 8][4]) {
  uint64_t b = 0;
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (acc[j][q] > 0.f) b |= uint64_t(1) << (4 * j + q);
  return b;
}

// acc = rnd(acc) where the activation was > 0, else 0 (the ReLU backward)
template <typename T, int H>
__device__ __forceinline__ void relu_grad(float (&acc)[H / 8][4],
                                          uint64_t bits) {
#pragma unroll
  for (int j = 0; j < H / 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[j][q] = (bits >> (4 * j + q)) & 1 ? Num<T>::rnd(acc[j][q]) : 0.f;
}

template <typename T, int H>
__host__ __device__ constexpr size_t rows_fixed_smem() {
  // fp32 operand staging (kRows rows), then per warp the LayerNorm column
  // sums of ln_backward and their running totals ([2][kWarps][H] each)
  return (sizeof(T) == 4 ? Layout<T, H>::kActBytes : 0) +
         2 * 2 * size_t(kWarps) * H * sizeof(float);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 1)
edge_rows_kernel(RowsBwdArgs<T> a, int resident) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nh = a.n_hidden, n_mats = nh + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr size_t kMat = WeightRing<T, H>::kMat;
  WeightRing<T, H> ring{reinterpret_cast<T*>(smem_raw), a.wb, resident, nh,
                        2 * n_mats, 0};
  unsigned char* rest =
      smem_raw + (resident ? n_mats * kCopies<T> : 2) * kMat * sizeof(T);
  float* stg_all = reinterpret_cast<float*>(rest);
  float* warp_part = reinterpret_cast<float*>(
      rest + (sizeof(T) == 4 ? Layout<T, H>::kActBytes : 0));
  float* vsum = warp_part + 2 * kWarps * H;  // [2][kWarps][H]
  T* stg = reinterpret_cast<T*>(stg_all) + warp * 16 * Layout<T, H>::kLd;
  for (int i = lane; i < H; i += 32) {
    vsum[warp * H + i] = 0.f;
    vsum[(kWarps + warp) * H + i] = 0.f;
  }
  __syncwarp();
  ring.start();

  RowOperand<T, H> op;
  float acc[H / 8][4];
  uint64_t bits[kMaxHidden + 1];
  const int64_t E = a.n_edges;
  for (int ch = blockIdx.x; ch < a.n_chunks; ch += gridDim.x) {
    const int64_t r0 = int64_t(ch) * kRows;
    // a chunk of a pad tile: nothing to do (the same for the whole CTA)
    if (N::load1(a.mask + r0 / a.edge_tile * a.edge_tile) == 0.f) continue;
    const int64_t ra = r0 + warp * 16 + g, rb = ra + 8;
    const int na = a.recv[ra], nb = a.recv[rb];
    const float ma = N::load1(a.mask + ra), mb = N::load1(a.mask + rb);
    auto store_rows_of = [&](T* base) {
      store_acc<T, H>(acc, base + ra * H, base + rb * H);
    };

    // ---- forward recompute, as K1 ----
    op.from_rows(a.e + ra * H, a.e + rb * H, stg);
    zero<H>(acc);
    op.template mm<false>(ring.get(0), acc, stg);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 sa = N::load2(a.sg + ra * H + col);
      const float2 sb = N::load2(a.sg + rb * H + col);
      const float2 da = N::load2(a.d_proj + int64_t(na) * H + col);
      const float2 db = N::load2(a.d_proj + int64_t(nb) * H + col);
      acc[j][0] = fmaxf(N::rnd(N::rnd(N::rnd(acc[j][0]) + sa.x) +
                               N::rnd(da.x * ma)), 0.f);
      acc[j][1] = fmaxf(N::rnd(N::rnd(N::rnd(acc[j][1]) + sa.y) +
                               N::rnd(da.y * ma)), 0.f);
      acc[j][2] = fmaxf(N::rnd(N::rnd(N::rnd(acc[j][2]) + sb.x) +
                               N::rnd(db.x * mb)), 0.f);
      acc[j][3] = fmaxf(N::rnd(N::rnd(N::rnd(acc[j][3]) + sb.y) +
                               N::rnd(db.y * mb)), 0.f);
    }
    for (int i = 0; i <= nh; ++i) {
      // acc holds a(i): keep it for the weight gradients and its mask
      store_rows_of(a.acts + i * E * H);
      bits[i] = relu_bits<H>(acc);
      op.from_acc(acc, stg);
      zero<H>(acc);
      op.template mm<false>(ring.get(1 + i), acc, stg);
      if (i < nh) {  // a(i + 1) = relu(rnd(rnd(acc) + bs[i]))
        const T* b = a.bs + size_t(i) * H;
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          const float2 bb = N::load2(b + 8 * j + 2 * t);
          acc[j][0] = fmaxf(N::rnd(N::rnd(acc[j][0]) + bb.x), 0.f);
          acc[j][1] = fmaxf(N::rnd(N::rnd(acc[j][1]) + bb.y), 0.f);
          acc[j][2] = fmaxf(N::rnd(N::rnd(acc[j][2]) + bb.x), 0.f);
          acc[j][3] = fmaxf(N::rnd(N::rnd(acc[j][3]) + bb.y), 0.f);
        }
      }
    }
    bias_round<T, H>(acc, a.b_out);  // d, the pre-LayerNorm output

    // ---- ct = ct_e + mask * ct_agg[recv]; LayerNorm backward ----
    {
      float ct[H / 8][4];
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 ea = N::load2(a.ct_e + ra * H + col);
        const float2 eb = N::load2(a.ct_e + rb * H + col);
        const float2 ga = N::load2(a.ct_agg + int64_t(na) * H + col);
        const float2 gb = N::load2(a.ct_agg + int64_t(nb) * H + col);
        ct[j][0] = N::rnd(ea.x + N::rnd(ma * ga.x));
        ct[j][1] = N::rnd(ea.y + N::rnd(ma * ga.y));
        ct[j][2] = N::rnd(eb.x + N::rnd(mb * gb.x));
        ct[j][3] = N::rnd(eb.y + N::rnd(mb * gb.y));
      }
      ln_backward<T, H>(acc, ct, a.ln_scale, warp_part);
    }
    if (g == 0) {  // this lane's columns of the warp's dscale / dbias sums
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = warp * H + 8 * j + 2 * t + q;
          vsum[c] += warp_part[c];
          vsum[kWarps * H + c] += warp_part[kWarps * H + c];
        }
    }

    // ---- acc = d_d: output linear and hidden stack, in reverse ----
    store_rows_of(a.cots + nh * E * H);
    op.from_acc(acc, stg);
    zero<H>(acc);
    op.template mm<true>(ring.get(nh + 2), acc, stg);
    relu_grad<T, H>(acc, bits[nh]);
    for (int i = nh - 1; i >= 0; --i) {
      store_rows_of(a.cots + i * E * H);  // dz(i + 1)
      op.from_acc(acc, stg);
      zero<H>(acc);
      op.template mm<true>(ring.get(2 * nh + 2 - i), acc, stg);
      relu_grad<T, H>(acc, bits[i]);
    }

    // ---- acc = dz(0) = d_sg; d_e = ct + dz @ W_e^T ----
    store_rows_of(a.d_sg);
    op.from_acc(acc, stg);
    zero<H>(acc);
    op.template mm<true>(ring.get(2 * nh + 3), acc, stg);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float2 ea = N::load2(a.ct_e + ra * H + col);
      const float2 eb = N::load2(a.ct_e + rb * H + col);
      const float2 ga = N::load2(a.ct_agg + int64_t(na) * H + col);
      const float2 gb = N::load2(a.ct_agg + int64_t(nb) * H + col);
      const float c0 = N::rnd(ea.x + N::rnd(ma * ga.x));
      const float c1 = N::rnd(ea.y + N::rnd(ma * ga.y));
      const float c2 = N::rnd(eb.x + N::rnd(mb * gb.x));
      const float c3 = N::rnd(eb.y + N::rnd(mb * gb.y));
      N::store2(a.d_e + ra * H + col, N::rnd(c0 + N::rnd(acc[j][0])),
                N::rnd(c1 + N::rnd(acc[j][1])));
      N::store2(a.d_e + rb * H + col, N::rnd(c2 + N::rnd(acc[j][2])),
                N::rnd(c3 + N::rnd(acc[j][3])));
    }
  }
  ring.finish();
  __syncthreads();
  // this CTA's dscale (vector 1) and dbias (vector 2): warps in order
  float* vec = a.part + int64_t(blockIdx.x) * a.part_len +
               int64_t(n_mats) * H * H;
  for (int c = tid; c < H; c += kThreads) {
    float sx = 0.f, sc = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      sx += vsum[w * H + c];
      sc += vsum[(kWarps + w) * H + c];
    }
    vec[H + c] = sx;
    vec[2 * H + c] = sc;
  }
}

// One CTA's [H, H] weight-gradient accumulator, summed slab by slab (A^T D
// over a slab's kSlab rows in shared memory) and written once.
template <typename T, int H>
struct DwAcc;

// bf16: each warp's TnTile (chain_bwd.cuh) in mma accumulators, fragments
// by ldmatrix.trans (as mm_tn).
template <int H>
struct DwAcc<__nv_bfloat16, H> {
  static constexpr int LD = Layout<__nv_bfloat16, H>::kLd;
  static constexpr int NT = TnTile<H>::NT;
  float acc[NT][4] = {};

  __device__ void add(const __nv_bfloat16* a, const __nv_bfloat16* d) {
    const int lane = threadIdx.x & 31, q = lane >> 3, r8 = lane & 7;
    const int m0 = TnTile<H>::m0(), n0 = TnTile<H>::n0();
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      uint32_t af[4];
      ldsm_x4_trans(af, a + (kk + r8 + (q >> 1) * 8) * LD + m0 + (q & 1) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, d + (kk + r8 + (q & 1) * 8) * LD + n0 + 8 * j +
                              (q >> 1) * 8);
        mma_bf16(acc[j], af, bf[0], bf[1]);
        mma_bf16(acc[j + 1], af, bf[2], bf[3]);
      }
    }
  }
  __device__ void store(float* mat) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int m0 = TnTile<H>::m0(), n0 = TnTile<H>::n0();
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(mat + (m0 + g) * H + c) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(mat + (m0 + g + 8) * H + c) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
};

// fp32 (FFMA): thread (ty, tx) of a 16 x 16 grid owns rows B ty .. B ty +
// B - 1 (B = H / 16) and the B / 4 column quads 4 tx + 64 k, so each slab
// row costs it B / 2 float4 loads for B * B products, the quads of a
// quarter warp side by side in shared memory (no bank conflict).
template <int H>
struct DwAcc<float, H> {
  static constexpr int LD = Layout<float, H>::kLd;
  static constexpr int B = H / 16;
  static_assert(B % 4 == 0, "blocks of whole float4 vectors");
  float acc[B][B] = {};

  __device__ void add(const float* a, const float* d) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 2
    for (int r = 0; r < kSlab; ++r) {
      float x[B], y[B];
#pragma unroll
      for (int v = 0; v < B; v += 4) {
        const float4 xa =
            *reinterpret_cast<const float4*>(a + r * LD + B * ty + v);
        const float4 yd =
            *reinterpret_cast<const float4*>(d + r * LD + 16 * v + 4 * tx);
        x[v] = xa.x, x[v + 1] = xa.y, x[v + 2] = xa.z, x[v + 3] = xa.w;
        y[v] = yd.x, y[v + 1] = yd.y, y[v + 2] = yd.z, y[v + 3] = yd.w;
      }
#pragma unroll
      for (int i = 0; i < B; ++i)
#pragma unroll
        for (int j = 0; j < B; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
  }
  __device__ void store(float* mat) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < B; ++i)
#pragma unroll
      for (int v = 0; v < B; v += 4)
        *reinterpret_cast<float4*>(mat + (B * ty + i) * H + 16 * v + 4 * tx) =
            make_float4(acc[i][v], acc[i][v + 1], acc[i][v + 2],
                        acc[i][v + 3]);
  }
};

constexpr int kFillSplit = 16;  // CTAs per pad tile in fill_pad_rows

// The rows of every pad tile (first row masked): d_e = ct_e, d_sg = 0.
// CTA (x, tile) copies part x of kFillSplit of its tile, 16 bytes per
// thread and store, so a pad tile costs a few round trips, not a CTA's
// serial walk; the CTAs of other tiles return at once.
template <typename T>
__global__ void __launch_bounds__(256)
fill_pad_rows(const T* __restrict__ mask, int edge_tile, int h,
              const T* __restrict__ ct_e, T* __restrict__ d_e,
              T* __restrict__ d_sg) {
  const int64_t tile = blockIdx.y;
  if (Num<T>::load1(mask + tile * edge_tile) != 0.f) return;
  const int64_t vecs = int64_t(edge_tile) * h * sizeof(T) / 16;
  const int64_t per = (vecs + kFillSplit - 1) / kFillSplit;
  const int64_t lo = tile * vecs + blockIdx.x * per;
  const int64_t hi = min(lo + per, (tile + 1) * vecs);
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    reinterpret_cast<uint4*>(d_e)[i] = reinterpret_cast<const uint4*>(ct_e)[i];
    reinterpret_cast<uint4*>(d_sg)[i] = zero4;
  }
}

template <typename T, int H>
__host__ __device__ constexpr size_t dw_smem() {
  return 2 * 2 * size_t(kSlab) * Layout<T, H>::kLd * sizeof(T);
}

// First chunk at or after q, stepping by `step`, that is not a pad tile's
// (n_chunks if none).
template <typename T>
__device__ __forceinline__ int live_chunk(const RowsBwdArgs<T>& a, int q,
                                          int step) {
  while (q < a.n_chunks &&
         Num<T>::load1(a.mask + int64_t(q) * kRows / a.edge_tile *
                                    a.edge_tile) == 0.f)
    q += step;
  return q;
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads)
edge_dw_kernel(RowsBwdArgs<T> a) {
  constexpr int LD = Layout<T, H>::kLd;
  constexpr int V = 16 / sizeof(T);
  constexpr int PER_ROW = H / V;
  constexpr size_t kTile = size_t(kSlab) * LD;
  constexpr int kParts = kThreads / H;  // column-sum partials per column
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [stage][A, D][kSlab][LD]
  const int s = blockIdx.x, p = blockIdx.y, step = gridDim.x;
  const int nh = a.n_hidden, tid = threadIdx.x;
  const int64_t EH = a.n_edges * H;
  const T* A = p == 0 ? a.e : a.acts + (p - 1) * EH;
  const T* D = p == 0 ? a.d_sg : a.cots + (p - 1) * EH;
  auto issue = [&](int q, int half, int stage) {
    const int64_t r0 = int64_t(q) * kRows + half * kSlab;
    T* ta = tiles + size_t(stage) * 2 * kTile;
    for (int i = tid; i < kSlab * PER_ROW; i += kThreads) {
      const int r = i / PER_ROW, c = (i % PER_ROW) * V;
      cp_async16(ta + r * LD + c, A + (r0 + r) * H + c);
      cp_async16(ta + kTile + r * LD + c, D + (r0 + r) * H + c);
    }
  };
  DwAcc<T, H> acc;
  const int col = tid % H, cpart = tid / H;
  float csum = 0.f;

  int q = live_chunk(a, s, step), half = 0, it = 0;
  if (q < a.n_chunks) issue(q, 0, 0);
  cp_async_commit();
  while (q < a.n_chunks) {
    const int qn = half ? live_chunk(a, q + step, step) : q;
    const int hn = half ^ 1;
    if (qn < a.n_chunks) issue(qn, hn, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ta = tiles + size_t(it & 1) * 2 * kTile;
    acc.add(ta, ta + kTile);
    constexpr int kRowsPer = kSlab / kParts;
    for (int r = cpart * kRowsPer; r < (cpart + 1) * kRowsPer; ++r)
      csum += Num<T>::load1(ta + kTile + r * LD + col);
    __syncthreads();  // stage it & 1 is free for the copy after next
    q = qn;
    half = hn;
    ++it;
  }
  cp_async_wait<0>();

  float* part = a.part + int64_t(s) * a.part_len;
  acc.store(part + int64_t(p) * H * H);
  if (p == 0) return;  // W_e has no bias
  float* red = reinterpret_cast<float*>(smem_raw);
  __syncthreads();
  red[cpart * H + col] = csum;
  __syncthreads();
  if (tid < H) {
    float v = 0.f;
    for (int k = 0; k < kParts; ++k) v += red[k * H + tid];
    // db_out (vector 0) from d_d, dbs[p - 1] (vector 3 + p - 1) from dz
    const int vi = p == nh + 1 ? 0 : 2 + p;
    part[int64_t(nh + 2) * H * H + vi * H + tid] = v;
  }
}

// Bytes of workspace the launch needs: the partials, then a(0..nh), then
// dz(1..nh), d_d, then d_dproj's row pointer (ops/hopper_fused.py
// edge_bwd_plan lays it out alike); the offset of the activations in
// *acts_at.
inline int64_t rows_bwd_workspace(int64_t n_edges, int64_t n_nodes, int h,
                                  int n_hidden, int grid, int elem,
                                  int64_t* acts_at) {
  const int64_t part_len =
      int64_t(n_hidden + 2) * h * h + int64_t(n_hidden + 3) * h;
  *acts_at = (int64_t(grid) * part_len * 4 + 255) / 256 * 256;
  return *acts_at + 2 * int64_t(n_hidden + 1) * n_edges * h * elem +
         (n_nodes + 1) * 4;
}

// The four launches (module comment) on `stream`; dw receives [dW_e,
// dWs[0..nh), dW_out] ([H, H] each) then [db_out, dscale, dbias,
// dbs[0..nh)] ([H] each), fp32.
template <typename T, int H>
cudaError_t launch_rows_bwd(RowsBwdArgs<T> a, float* dw, void* workspace,
                            int64_t ws_bytes, int grid,
                            cudaStream_t stream) {
  const int nh = a.n_hidden, n_mats = nh + 2;
  if (nh < 0 || nh > kMaxHidden || grid <= 0 || a.n_edges % kRows ||
      a.edge_tile % kRows)
    return cudaErrorInvalidValue;
  int64_t acts_at = 0;
  const int64_t need = rows_bwd_workspace(a.n_edges, a.n_nodes, H, nh, grid,
                                          sizeof(T), &acts_at);
  if (ws_bytes < need) return cudaErrorInvalidValue;
  a.n_chunks = int(a.n_edges / kRows);
  a.part_len = int64_t(n_mats) * H * H + int64_t(nh + 3) * H;
  char* ws = static_cast<char*>(workspace);
  a.part = reinterpret_cast<float*>(ws);
  const int64_t act_bytes = int64_t(nh + 1) * a.n_edges * H * sizeof(T);
  a.acts = reinterpret_cast<T*>(ws + acts_at);
  a.cots = reinterpret_cast<T*>(ws + acts_at + act_bytes);
  a.offsets = reinterpret_cast<int*>(ws + acts_at + 2 * act_bytes);

  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t fixed = rows_fixed_smem<T, H>();
  const size_t mat = Layout<T, H>::kMatBytes;
  const int n_stored = n_mats * kCopies<T>;
  const int resident = n_stored * mat + fixed <= size_t(max_smem);
  const size_t smem = (resident ? n_stored : 2) * mat + fixed;
  if (smem > size_t(max_smem) || dw_smem<T, H>() > size_t(max_smem))
    return cudaErrorInvalidValue;

  auto rows = edge_rows_kernel<T, H>;
  err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return err;
  rows<<<grid, kThreads, smem, stream>>>(a, resident);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fill_pad_rows<T><<<dim3(kFillSplit, unsigned(a.n_edges / a.edge_tile)),
                     256, 0, stream>>>(a.mask, a.edge_tile, H, a.ct_e, a.d_e,
                                       a.d_sg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = segrows::launch<T, false>(a.d_sg, a.recv, a.mask, nullptr, nullptr,
                                  a.offsets, a.d_dproj, a.n_edges, a.n_nodes,
                                  H, 1, stream);
  if (err != cudaSuccess) return err;
  auto dwk = edge_dw_kernel<T, H>;
  err = cudaFuncSetAttribute(dwk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(dw_smem<T, H>()));
  if (err != cudaSuccess) return err;
  dwk<<<dim3(grid, n_mats), kThreads, dw_smem<T, H>(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(a.part, grid, a.part_len, dw, stream);
}

}  // namespace chain
