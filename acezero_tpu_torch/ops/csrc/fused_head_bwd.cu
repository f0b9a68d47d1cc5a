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

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int C = 512;                  // head width
constexpr int BM = 64;                  // rows per tile
constexpr int THREADS = 256;            // two warpgroups
constexpr int MAX_LAYERS = 64;
constexpr int KS = 32;                  // reduction depth of one W slab
constexpr int SLABS = C / KS;           // slabs per layer GEMM
constexpr int STAGES = 3;               // W ring slots
constexpr int CHUNKS = C / 8;           // 16-byte chunks per row
constexpr uint32_t ATOM_BYTES = BM * 128;               // 64 rows x 64 columns
constexpr uint32_t ACT_BYTES = BM * C * 2;               // 64 KiB
constexpr uint32_t SLAB_BYTES = KS * C * 2;              // 32 KiB
constexpr uint32_t FWD_BOX_BYTES = KS * 64 * 2;          // 32 rows x 64 columns
constexpr uint32_t BWD_BOX_BYTES = 256 * KS * 2;         // 256 rows x 32 columns
constexpr uint32_t BIAS_BYTES = C * 4;                   // one layer's bias, f32
// buffers, W slots, bias, full barriers; the base is 1 KiB-aligned
constexpr uint32_t SMEM_BYTES = 2 * ACT_BYTES + STAGES * SLAB_BYTES + BIAS_BYTES + STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "shared memory over the per-block limit");
constexpr uint64_t SW128 = 1, SW64 = 2;                  // wgmma descriptor layout types

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) in a 64 x 512 activation buffer: atom c / 64,
// row r at 128 bytes, 16-byte chunk (c / 8) % 8 swizzled with r % 8.
__device__ __forceinline__ uint32_t act_off(int r, int c) {
    return (c >> 6) * ATOM_BYTES + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// The offsets of a thread's accumulator elements. Element (rbase + 8 h,
// cbase + 8 j) with rbase % 8 = lane / 4 and cbase = 256 wg + 2 (lane % 4)
// sits at base[j % 8] + (j / 8) * ATOM_BYTES + h * 1024: eight per-thread
// bases, the rest immediates (64 offsets kept live would spill).
struct AccOffsets {
    uint32_t base[8];
    __device__ __forceinline__ AccOffsets(int rbase, int cbase) {
#pragma unroll
        for (int k = 0; k < 8; ++k) base[k] = act_off(rbase, cbase + 8 * k);
    }
    __device__ __forceinline__ uint32_t operator()(int j, int h) const {
        return base[j & 7] + (j >> 3) * ATOM_BYTES + h * 1024;
    }
};

// ---- mbarrier and TMA --------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// Shared -> global: one box of `map` at (c0, c1, c2) from the swizzled
// buffer at src, completing in the thread's bulk async-group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2) {
    asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
                 ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}
__device__ __forceinline__ void tma_store_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// The shared sources of this thread's bulk stores have been read.
__device__ __forceinline__ void tma_store_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// ---- wgmma -------------------------------------------------------------
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
           (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// Pin the accumulators: no access to them moves across this point.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
    for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) = A @ B (+ d when scale_d): A K-major, B K-major
// (TRANS_B = 0) or MN-major (TRANS_B = 1), both from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

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

__device__ __forceinline__ __nv_bfloat162 add_bf162(__nv_bfloat162 a, __nv_bfloat162 b) {
    const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
    return __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime.
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A map over a (L, rows, 512) bf16 array whose box is box_cols x box_rows
// of one layer.
CUresult layer_map(EncodeTiled enc, CUtensorMap* map, const void* base, int L, int rows, uint32_t box_cols,
                   uint32_t box_rows, CUtensorMapSwizzle swizzle) {
    const cuuint64_t dims[3] = {C, cuuint64_t(rows), cuuint64_t(L)};
    const cuuint64_t strides[2] = {C * 2, cuuint64_t(rows) * C * 2};
    const cuuint32_t box[3] = {box_cols, box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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
