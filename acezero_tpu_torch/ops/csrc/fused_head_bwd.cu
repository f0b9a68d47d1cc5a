// Fused scene-coordinate head chain, backward, for Hopper (sm_90a).
//
// Replaces acezero_tpu/ops/fused_head.py::_backward_kernel (launched by
// _run_backward, pallas_call at fused_head.py:153): a recompute-based
// backward of the chain that fused_head_fwd.cu runs forward. Per 64-row tile
//   1. rerun the forward exactly as the forward kernel does (f32
//      accumulation, + b, ReLU, bf16 rounding, bf16 residual adds), writing
//      acts_in[l] (the bf16 input of layer l) and the ReLU mask
//      mask[l] = (pre_l > 0) of the f32 pre-activation;
//   2. walk back from g = bf16(g_in), g_res = 0: for l = L-1 .. 0,
//        if res_after[l]: g = bf16(g + g_res); g_res = g
//        gpre[l] = g * mask[l]                  (exact in bf16)
//        g = bf16(gpre[l] @ W[l]^T)             (f32 accumulation)
//   3. write dx = bf16(g + g_res).
// dW = acts_in^T gpre and db = sum(gpre) run outside, as in JAX.
//
// Shapes: x, g, dx (B, 512) bf16; W (L, 512, 512) bf16 in (cin, cout)
// layout; b (L, 512) f32; gpre, acts_in (L, B, 512) bf16; mask scratch
// (L, ceil(B / 64), 256 threads, 4 words): each thread's 128 accumulator
// bits of a layer, in the thread's own accumulator order. Any B (rows of the
// last tile past B are zero and never stored), any L <= 64, any res_after.
//
// What bounds it on an H100 SXM at the mapping shape (B = 5,120, L = 8):
// - Operations: 4 * B * 512^2 * L = 42.9 GFLOP, 0.043 ms at the 989 TFLOP/s
//   bf16 dense peak; the bytes that must move (x, g, dx, gpre, acts_in, W
//   once) take 0.031 ms at 3.35 TB/s.
// - Fill: a tile carries its activations through all 2L GEMMs, so B = 5,120
//   is 80 tiles for 132 SMs. Each tile does 16 * 2 * 64 * 512^2 = 537 MFLOP,
//   72 us at 989/132 = 7.49 TFLOP/s per SM: the floor with 80 tiles.
// - W from L2: every tile streams every layer's W twice, 16 * 512 KiB =
//   8 MiB, 640 MiB per launch. A 64-row tile does 64 MACs per W element, so
//   an SM at its full tensor rate needs 64 bytes of W per clock. The TMA ring
//   alone, with no arithmetic, streams it in about 0.1 ms at 80 tiles (about
//   6.8 TB/s from L2): the second floor, and the one this design meets
//   first. Sharing W between tiles (a cluster multicast) lowers the L2
//   traffic, not the bytes each SM must take in.
//
// Design:
// - One block of two warpgroups (256 threads) owns a 64-row tile for the
//   whole chain. Each warpgroup computes a 64 x 256 half of every layer's
//   output with wgmma.mma_async m64n256k16 (bf16 in, f32 accumulate in 128
//   registers a thread), both operands read from shared memory.
// - Activations: two 64 x 512 bf16 buffers (forward: the residual stream and
//   the working h; backward: g and g_res), 128 KiB, in the 128-byte-swizzled
//   K-major layout that a wgmma descriptor reads as A: 8 atoms of 64 columns
//   (8 KiB each); a k16 step moves the descriptor 32 bytes inside an atom.
// - W: a ring of 3 slabs of 32 KiB fed by TMA, each slab completing on an
//   mbarrier with its byte count. The slab order is fixed (L forward
//   layers, then L backward layers, 16 slabs each), so the ring runs
//   straight through layer boundaries and the next layer's W loads during
//   an epilogue. A slot is refilled after a block barrier that follows the
//   wgmma wait retiring its slab. Shared memory holds nothing else but the
//   layer's bias (2 KiB) and the barriers: 231,448 of 232,448 bytes.
// - One W tile, two roles, no transposed copy: forward, a slab is
//   W[l][32s:32s+32, :] (8 boxes of 32 x 64, 128B swizzle) and B[k][n] =
//   W[k][n] is MN-major (wgmma's transpose flag for B); backward, a slab is
//   W[l][:, 32s:32s+32] (2 boxes of 256 x 32, 64B swizzle) and B[k][n] =
//   W[n][k] is K-major.
// - Epilogues work from the accumulator registers: bias (staged in shared
//   memory by cp.async during the GEMM), ReLU, bf16 rounding and the bf16
//   residual add going forward; the mask, the join of the skip path and the
//   next layer's masking going back (one layer's elementwise step is fused
//   into the epilogue of the GEMM before it). Results go to the swizzled
//   buffer as bf16x2; mask bits stay in the thread's own order, four 32-bit
//   words a thread and layer.
// - A layer's A buffer is an output as it stands (acts_in[l] forward,
//   gpre[l] back): TMA stores its 8 atoms while the tensor cores run, and
//   clips the rows past B.
// - Two hazards: an epilogue that overwrites its layer's A waits for every
//   wgmma (wait_group 0), for the TMA stores to have read A, and for a block
//   barrier first; generic stores to a buffer that wgmma or TMA reads next
//   are followed by fence.proxy.async before the barrier.
// - Host: the four tensor maps are encoded on every launch (W is restacked
//   every training step; cuTensorMapEncodeTiled comes through the runtime's
//   driver entry point, so no -lcuda) and passed as __grid_constant__
//   parameters.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 256;            // two warpgroups
constexpr int MAX_LAYERS = 64;
constexpr int KS = 32;                  // reduction depth of one W slab
constexpr int SLABS = C / KS;           // slabs per layer GEMM
constexpr int STAGES = 3;               // W ring slots
constexpr uint32_t SLAB_BYTES = KS * C * 2;              // 32 KiB
constexpr uint32_t FWD_BOX_BYTES = KS * 64 * 2;          // 32 rows x 64 columns
constexpr uint32_t BWD_BOX_BYTES = 256 * KS * 2;         // 256 rows x 32 columns
constexpr uint32_t BIAS_BYTES = C * 4;                   // one layer's bias, f32
// buffers, W slots, bias, full barriers; the base is 1 KiB-aligned
constexpr uint32_t SMEM_BYTES = 2 * ACT_BYTES + STAGES * SLAB_BYTES + BIAS_BYTES + STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "shared memory over the per-block limit");

// ---- the W ring ----------------------------------------------------------
struct Ring {
    uint32_t slots;  // shared address of slot 0
    uint32_t full;   // shared address of slot 0's full barrier
    int total;       // slabs in the launch: 2 * SLABS * L
    int L;
};

// Slab n: forward slabs first (layer n / SLABS, rows 32s.. of W), then the
// backward ones (layers L-1 .. 0, columns 32s.. of W). One thread issues it.
__device__ __forceinline__ void issue_slab(const Ring& ring, int n, const CUtensorMap* w_fwd, const CUtensorMap* w_bwd) {
    const int slot = n % STAGES;
    const uint32_t dst = ring.slots + slot * SLAB_BYTES;
    const uint32_t bar = ring.full + slot * 8;
    mbar_expect_tx(bar, SLAB_BYTES);
    if (n < SLABS * ring.L) {
        const int l = n / SLABS, s = n % SLABS;
#pragma unroll
        for (int c = 0; c < C / 64; ++c) tma_load_3d(dst + c * FWD_BOX_BYTES, w_fwd, bar, c * 64, s * KS, l);
    } else {
        const int m = n - SLABS * ring.L;
        const int l = ring.L - 1 - m / SLABS, s = m % SLABS;
#pragma unroll
        for (int h = 0; h < 2; ++h) tma_load_3d(dst + h * BWD_BOX_BYTES, w_bwd, bar, s * KS, h * 256, l);
    }
}

// acc = A (64 x 512 in the buffer at shared address a) @ op(W[l]) for this
// warpgroup's 256 columns, from ring slabs n0 .. n0 + SLABS - 1. While the
// tensor cores run, TMA stores A to layer l of out_map (acts_in or gpre;
// rows past B are clipped). Returns with every wgmma retired and A read by
// the stores, after a block barrier, and with the next slab issued into the
// slot this layer's last slab leaves free.
template <int TRANS_B>
__device__ __forceinline__ void layer_gemm(float (&acc)[128], uint32_t a, const Ring& ring, int n0,
                                           const CUtensorMap* w_fwd, const CUtensorMap* w_bwd,
                                           const CUtensorMap* out_map, int l, int row0, int tid, int wg) {
    // a fresh definition: without it the previous layer's accumulators stay
    // live through its epilogue (the wgmma operands are read-write)
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (int s = 0; s < SLABS; ++s) {
        const int n = n0 + s;
        const int slot = n % STAGES;
        mbar_wait(ring.full + slot * 8, (n / STAGES) & 1);
        const uint32_t w = ring.slots + slot * SLAB_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            const int t = 2 * s + kk;  // k16 step of the layer
            const uint64_t da = make_desc(a + (t >> 2) * ATOM_BYTES + (t & 3) * 32, 16, 1024, SW128);
            // forward: 4 column atoms of 64 (LBO 4 KiB apart), 8-row k groups
            // 1 KiB apart; backward: 256 rows of 64 bytes, 8-row groups 512 B apart
            const uint64_t db = TRANS_B
                ? make_desc(w + wg * 4 * FWD_BOX_BYTES + kk * 16 * 128, FWD_BOX_BYTES, 1024, SW128)
                : make_desc(w + wg * BWD_BOX_BYTES + kk * 32, 16, 512, SW64);
            wgmma_m64n256k16<TRANS_B>(acc, da, db, (s | kk) != 0);
        }
        wgmma_commit();
        if ((s & 1) == 0 && tid == 0) {  // one 8 KiB atom every other slab
            tma_store_3d(out_map, a + (s >> 1) * ATOM_BYTES, 64 * (s >> 1), row0, l);
            tma_store_commit();
        }
        if (s > 0) {
            wgmma_wait<1>();  // slab n - 1 retired in this warpgroup
            __syncthreads();  // ... and in the other
            if (tid == 0 && n + 2 < ring.total) issue_slab(ring, n + 2, w_fwd, w_bwd);
            __syncwarp();
        }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (tid == 0) tma_store_wait_read();
    __syncthreads();
    if (tid == 0 && n0 + SLABS + 2 < ring.total) issue_slab(ring, n0 + SLABS + 2, w_fwd, w_bwd);
    __syncwarp();
}

// Keep the halves of v whose mask bits (bit i, bit i + 1 of the thread's
// 128) are set; zero the others.
__device__ __forceinline__ __nv_bfloat162 mask_bf162(__nv_bfloat162 v, const uint32_t (&mw)[4], int i) {
    const uint32_t bits = mw[i >> 5] >> (i & 31);
    uint32_t u = *reinterpret_cast<uint32_t*>(&v);
    u &= ((bits & 1u) ? 0x0000FFFFu : 0u) | ((bits & 2u) ? 0xFFFF0000u : 0u);
    return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_head_bwd_kernel(const __grid_constant__ CUtensorMap w_fwd, const __grid_constant__ CUtensorMap w_bwd,
                      const __grid_constant__ CUtensorMap acts_map, const __grid_constant__ CUtensorMap gpre_map,
                      const __nv_bfloat16* __restrict__ x, const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ g_in, __nv_bfloat16* __restrict__ dx,
                      uint4* __restrict__ masks, int B, int L, unsigned long long res_bits) {
    // 1 KiB alignment: the swizzle patterns repeat on absolute address bits
    // (no room is left to align by hand; a misaligned base traps)
    extern __shared__ __align__(1024) unsigned char smem[];
    if (smem_u32(smem) & 1023u) __trap();
    unsigned char* buf0 = smem;
    unsigned char* buf1 = smem + ACT_BYTES;
    const uint32_t a0 = smem_u32(buf0), a1 = smem_u32(buf1);
    const uint32_t slots = smem_u32(smem + 2 * ACT_BYTES);
    float* bias_s = reinterpret_cast<float*>(smem + 2 * ACT_BYTES + STAGES * SLAB_BYTES);
    Ring ring{slots, slots + STAGES * SLAB_BYTES + BIAS_BYTES, 2 * SLABS * L, L};

    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int lane = tid % 32;
    // this thread's accumulator elements: rows rbase, rbase + 8; columns
    // cbase + 8 j, + 1 for j < 32 (register 4 j + 2 h + e)
    const int rbase = 16 * ((tid % 128) / 32) + lane / 4;
    const int cbase = 256 * wg + 2 * (lane % 4);
    const AccOffsets acc_off(rbase, cbase);
    const int row0 = blockIdx.x * BM;
    const int tiles = gridDim.x;

    if (tid == 0) {
        for (int i = 0; i < STAGES; ++i) mbar_init(ring.full + 8 * i, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        for (int n = 0; n < STAGES && n < ring.total; ++n) issue_slab(ring, n, &w_fwd, &w_bwd);
    }
    __syncwarp();

    // ---- 1. forward recompute: buf0 = residual stream, buf1 = working h ----
    for (int i = tid; i < BM * CHUNKS; i += THREADS) {
        const int r = i / CHUNKS, q = i % CHUNKS;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < B) v = *reinterpret_cast<const uint4*>(x + size_t(row0 + r) * C + q * 8);
        *reinterpret_cast<uint4*>(buf0 + act_off(r, q * 8)) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    float acc[128];
    bool h_is_res = true;
    for (int l = 0; l < L; ++l) {
        const bool is_res = (res_bits >> l) & 1ull;
        const uint32_t a = h_is_res ? a0 : a1;
        // this layer's bias into shared memory while the tensor cores run
        // (the epilogue reads it 32 times a thread; from device memory those
        // loads stall the epilogue)
        if (tid < BIAS_BYTES / 16) {
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         ::"r"(smem_u32(bias_s) + 16 * tid), "l"(bias + size_t(l) * C + 4 * tid) : "memory");
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
        layer_gemm<1>(acc, a, ring, l * SLABS, &w_fwd, &w_bwd, &acts_map, l, row0, tid, wg);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        unsigned char* dst = is_res ? buf0 : buf1;
        uint32_t mw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int c = cbase + 8 * j;
            const float2 bb = *reinterpret_cast<const float2*>(bias_s + c);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = 4 * j + 2 * h;
                const float p0 = acc[i] + bb.x, p1 = acc[i + 1] + bb.y;
                mw[i >> 5] |= (p0 > 0.0f ? 1u : 0u) << (i & 31);
                mw[i >> 5] |= (p1 > 0.0f ? 1u : 0u) << ((i + 1) & 31);
                __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(p0, 0.0f), fmaxf(p1, 0.0f));
                __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(dst + acc_off(j, h));
                if (is_res) v = add_bf162(*p, v);
                *p = v;
            }
        }
        masks[(size_t(l) * tiles + blockIdx.x) * THREADS + tid] = make_uint4(mw[0], mw[1], mw[2], mw[3]);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        h_is_res = is_res;
    }

    // ---- 2. walk back: buf0 = g (masked: gpre of the next GEMM), buf1 = g_res
    // layer L-1's join and mask, applied to g_in (g_res = 0)
    {
        const uint4 m4 = masks[(size_t(L - 1) * tiles + blockIdx.x) * THREADS + tid];
        const uint32_t mw[4] = {m4.x, m4.y, m4.z, m4.w};
        const bool is_res = (res_bits >> (L - 1)) & 1ull;
        const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int c = cbase + 8 * j;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int r = rbase + 8 * h;
                const uint32_t off = acc_off(j, h);
                __nv_bfloat162 v = zero;
                if (row0 + r < B) v = *reinterpret_cast<const __nv_bfloat162*>(g_in + size_t(row0 + r) * C + c);
                if (is_res) v = add_bf162(v, zero);
                *reinterpret_cast<__nv_bfloat162*>(buf1 + off) = is_res ? v : zero;
                *reinterpret_cast<__nv_bfloat162*>(buf0 + off) = mask_bf162(v, mw, 4 * j + 2 * h);
            }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
    }
    for (int l = L - 1; l >= 0; --l) {
        uint32_t mw[4] = {0u, 0u, 0u, 0u};
        if (l > 0) {
            const uint4 m4 = masks[(size_t(l - 1) * tiles + blockIdx.x) * THREADS + tid];
            mw[0] = m4.x; mw[1] = m4.y; mw[2] = m4.z; mw[3] = m4.w;
        }
        layer_gemm<0>(acc, a0, ring, (2 * L - 1 - l) * SLABS, &w_fwd, &w_bwd, &gpre_map, l, row0, tid, wg);
        // g = bf16(gpre[l] @ W[l]^T); then layer l-1's join and mask, or dx
        const bool prev_res = l > 0 && ((res_bits >> (l - 1)) & 1ull);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int c = cbase + 8 * j;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = 4 * j + 2 * h;
                const uint32_t off = acc_off(j, h);
                __nv_bfloat162 v = __floats2bfloat162_rn(acc[i], acc[i + 1]);
                __nv_bfloat162* gres = reinterpret_cast<__nv_bfloat162*>(buf1 + off);
                __nv_bfloat162* gout = reinterpret_cast<__nv_bfloat162*>(buf0 + off);
                if (l == 0) {
                    *gout = add_bf162(v, *gres);  // dx
                } else {
                    if (prev_res) {
                        v = add_bf162(v, *gres);
                        *gres = v;
                    }
                    *gout = mask_bf162(v, mw, i);
                }
            }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
    }

    // ---- 3. dx --------------------------------------------------------------
    for (int i = tid; i < BM * CHUNKS; i += THREADS) {
        const int r = i / CHUNKS, q = i % CHUNKS;
        if (row0 + r < B) {
            *reinterpret_cast<uint4*>(dx + size_t(row0 + r) * C + q * 8) =
                *reinterpret_cast<const uint4*>(buf0 + act_off(r, q * 8));
        }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" {

// x, g, dx: (B, 512) bf16; w: (L, 512, 512) bf16, 16-byte aligned; b: (L,
// 512) f32; gpre, acts_in: (L, B, 512) bf16; masks: scratch of
// L * ceil(B / 64) * 4096 bytes; res_after: host array of L ints. Launches on
// `stream` and returns cudaGetLastError(), cudaErrorNotSupported when the
// driver has no cuTensorMapEncodeTiled, or 10000 + the CUresult when it
// refuses a map.
int fused_head_bwd(const void* x, const void* w, const void* b, const void* g,
                   const int* res_after, void* dx, void* gpre, void* acts_in,
                   void* masks, int B, int L, cudaStream_t stream) {
    if (B < 0 || L < 1 || L > MAX_LAYERS || res_after == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0) return 0;
    unsigned long long res_bits = 0;
    for (int l = 0; l < L; ++l) res_bits |= (res_after[l] ? 1ull : 0ull) << l;
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    // W: forward slabs as 32 x 64 boxes (128B swizzle), backward slabs as
    // 256 x 32 boxes (64B swizzle); acts_in and gpre: 64-row atoms of the
    // activation buffers (128B swizzle; a tile's rows past B are clipped)
    CUtensorMap w_fwd, w_bwd, acts_map, gpre_map;
    const uint32_t tile_rows = B < BM ? static_cast<uint32_t>(B) : BM;
    CUresult r = layer_map(enc, &w_fwd, w, L, C, 64, KS, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r == CUDA_SUCCESS) r = layer_map(enc, &w_bwd, w, L, C, KS, 256, CU_TENSOR_MAP_SWIZZLE_64B);
    if (r == CUDA_SUCCESS) r = layer_map(enc, &acts_map, acts_in, L, B, 64, tile_rows, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r == CUDA_SUCCESS) r = layer_map(enc, &gpre_map, gpre, L, B, 64, tile_rows, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
    const cudaError_t err = cudaFuncSetAttribute(fused_head_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int grid = (B + BM - 1) / BM;
    fused_head_bwd_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
        w_fwd, w_bwd, acts_map, gpre_map, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(b),
        static_cast<const __nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(dx), static_cast<uint4*>(masks), B, L,
        res_bits);
    return static_cast<int>(cudaGetLastError());
}

// The kernel's resources: info[0] dynamic shared bytes, [1] threads, [2] rows
// per tile, [3] registers per thread, [4] local (stack and spill) bytes per
// thread. Returns cudaFuncGetAttributes' error.
int fused_head_bwd_info(int* info) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fused_head_bwd_kernel);
    info[0] = static_cast<int>(SMEM_BYTES);
    info[1] = THREADS;
    info[2] = BM;
    info[3] = err == cudaSuccess ? a.numRegs : -1;
    info[4] = err == cudaSuccess ? static_cast<int>(a.localSizeBytes) : -1;
    return static_cast<int>(err);
}

}  // extern "C"
