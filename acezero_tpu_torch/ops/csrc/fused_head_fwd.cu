// Fused scene-coordinate head chain, forward, for Hopper (sm_90a).
//
// Replaces acezero_tpu/ops/fused_head.py::_forward_kernel (body at :108,
// launched by _run_forward, pallas_call at :136; chain in _chain_forward):
// L layers of
//     a = bf16(relu(h @ W[l] + b[l]))        (f32 accumulation)
// with a bf16 residual add after every layer tagged in res_after
// (res = res + a; h = res), otherwise h = a. The chain starts from
// h = res = x. fc3 and the homogeneous epilogue stay outside.
//
// Shapes: x (B, 512) bf16, W (L, 512, 512) bf16 in (cin, cout) layout,
// b (L, 512) f32, out (B, 512) bf16. Any B (rows of the last tile past B
// are zero and never stored), any L <= 64 and any res_after.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 132 SMs, 3.35 TB/s):
// - Operations: 2 * B * 512^2 * L; at the registration shape (B = 307,200,
//   L = 8) 1.29 TFLOP, 1.30 ms; at the mapping shape (B = 5,120) 0.022 ms.
//   The bytes that must move (x, out, W, b once) take less at both.
// - Fill: a tile carries its activations through all L layers, so B = 5,120
//   is 80 tiles for 132 SMs; one tile is 268 MFLOP, 36 us at 989/132 TFLOP/s:
//   the floor at the mapping shape. B = 307,200 is 4,800 tiles, 36.4 a SM.
// - W and shared memory: a 64-row tile does 64 MACs per W element, so at the
//   tensor rate an SM takes in 64 bytes of W a clock from L2 (4 MiB a tile
//   at L = 8, 20 GB a launch at the registration shape). Every 32-row slab
//   costs 72 KiB of shared-memory traffic (32 KiB written by TMA, 40 KiB
//   read by wgmma), 576 clocks at 128 bytes a clock, against 512 clocks of
//   tensor work: the GEMMs can run at most at about 89% of the tensor rate.
//   What is left beyond that (the probe's profile of a tile): the epilogues,
//   during which the tensor cores idle, and waits on the W ring.
//
// Design:
// - Stage 1, the forward half of fused_head_bwd.cu: one block of two
//   warpgroups (256 threads) per 64-row tile; each warpgroup computes a
//   64 x 256 half of every layer with wgmma.mma_async m64n256k16, both
//   operands from shared memory in 128B-swizzled layouts (hopper.cuh,
//   act_off); W streams through a TMA ring of 32 KiB slabs (W[l][32s:32s+32,
//   :], read as MN-major B) that runs straight through layer boundaries, each
//   slab completing on an mbarrier with its byte count; the bias is staged by
//   cp.async during the GEMM; the epilogue works from the accumulator
//   registers and writes the tile's A in place (after every wgmma of the
//   layer has retired and a block barrier); x arrives by TMA and out leaves
//   by a TMA store that clips rows past B.
// - Stage 2, a deeper ring: the residual stream lives in registers (64
//   bf16x2 a thread, at the thread's own accumulator elements; 217 registers,
//   no spill), so shared memory holds one activation buffer and 5 slabs of W
//   (231,472 bytes). The depth alone bought nothing: the ring was bound by
//   TMA's cost per box (8 boxes of 4 KiB a slab), not by bytes in flight. A
//   slab is now one box of a 4-D map whose row and atom strides are out of
//   order (hopper.cuh, atom_map), which lands it as 8 swizzled column atoms;
//   that made the ring about 1.6x faster, and then 4-5 slabs beat 3 at the
//   registration shape.
// - The epilogue rounds to bf16 first and takes the ReLU and the residual
//   add in bf16x2 (the same values: rounding is monotonic, keeps zero, and
//   the bf16 add rounds the exact sum once).
// - Stage 3, a persistent grid: min(tiles, SMs) blocks, each walking tiles
//   with stride gridDim.x; the ring's slab order repeats per tile, so it runs
//   on through tile boundaries and the next tile's first slabs load during
//   the last epilogue; the next x loads into the buffer once the TMA store of
//   the last out has read it; the mbarrier phases run on across tiles.
// - Host: the shared-memory opt-in and the SM count once per device; the
//   three tensor maps are encoded on every launch (cuTensorMapEncodeTiled
//   through the runtime's driver entry point, no -lcuda) and passed as
//   __grid_constant__ parameters.
// `python3 -m acezero_tpu_torch.ops.probe_fwd` times each of these choices
// against its alternative and profiles a tile.

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int THREADS = 256;            // two warpgroups
constexpr int MAX_LAYERS = 64;
constexpr int KS = 32;                  // reduction depth of one W slab
constexpr int SLABS = C / KS;           // slabs per layer GEMM
constexpr int STAGES = 5;               // W ring slots
constexpr uint32_t SLAB_BYTES = KS * C * 2;              // 32 KiB
constexpr uint32_t BOX_BYTES = KS * 64 * 2;              // a slab's column atom: 32 rows x 64 columns
constexpr uint32_t BIAS_BYTES = C * 4;                   // one layer's bias, f32
// activations, W slots, bias, full barriers and the x barrier; the base is 1 KiB-aligned
constexpr uint32_t SMEM_BYTES = ACT_BYTES + STAGES * SLAB_BYTES + BIAS_BYTES + (STAGES + 1) * 8;
static_assert(SMEM_BYTES <= 232448, "shared memory over the per-block limit");

struct Ring {
    uint32_t slots;  // shared address of slot 0
    uint32_t full;   // shared address of slot 0's full barrier
    int total;       // slabs in the launch
    int L;
};

// Slab n: layer (n / SLABS) % L, rows 32 (n % SLABS) .. of W, as one TMA
// box of 8 column atoms. One thread issues it.
__device__ __forceinline__ void issue_slab(const Ring& ring, int n, const CUtensorMap* w_map) {
    const int slot = n % STAGES;
    const uint32_t bar = ring.full + slot * 8;
    const int l = (n / SLABS) % ring.L, s = n % SLABS;
    mbar_expect_tx(bar, SLAB_BYTES);
    tma_load_4d(ring.slots + slot * SLAB_BYTES, w_map, bar, 0, s * KS, 0, l);
}

// acc = A (64 x 512 in the buffer at shared address a) @ W[l] for this
// warpgroup's 256 columns, from ring slabs n0 .. n0 + SLABS - 1. Returns with
// every wgmma retired and the thread's cp.async copies landed, after a block
// barrier, and with the next slab issued into the slot this layer's last
// slab leaves free.
__device__ __forceinline__ void layer_gemm(float (&acc)[128], uint32_t a, const Ring& ring, int n0,
                                           const CUtensorMap* w_map, int tid, int wg) {
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
            // 4 column atoms of 64 (LBO 4 KiB apart), 8-row k groups 1 KiB apart
            const uint64_t db = make_desc(w + wg * 4 * BOX_BYTES + kk * 16 * 128, BOX_BYTES, 1024, SW128);
            wgmma_m64n256k16<1>(acc, da, db, (s | kk) != 0);
        }
        wgmma_commit();
        if (s > 0) {
            wgmma_wait<1>();  // slab n - 1 retired in this warpgroup
            __syncthreads();  // ... and in the other
            if (tid == 0 && n - 1 + STAGES < ring.total) issue_slab(ring, n - 1 + STAGES, w_map);
            __syncwarp();
        }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // the layer's bias, staged during the GEMM
    __syncthreads();
    if (tid == 0 && n0 + SLABS - 1 + STAGES < ring.total) issue_slab(ring, n0 + SLABS - 1 + STAGES, w_map);
    __syncwarp();
}

__global__ void __launch_bounds__(THREADS, 1)
fused_head_fwd_kernel(const __grid_constant__ CUtensorMap w_map, const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap out_map, const float* __restrict__ bias, int tiles, int L,
                      unsigned long long res_bits, uint32_t x_bytes) {
    // 1 KiB alignment: the swizzle patterns repeat on absolute address bits
    extern __shared__ __align__(1024) unsigned char smem[];
    if (smem_u32(smem) & 1023u) __trap();
    unsigned char* act = smem;  // h: the GEMM's A, overwritten in place by its epilogue
    const uint32_t a = smem_u32(act);
    const uint32_t slots = a + ACT_BYTES;
    float* bias_s = reinterpret_cast<float*>(smem + ACT_BYTES + STAGES * SLAB_BYTES);
    const uint32_t bars = slots + STAGES * SLAB_BYTES + BIAS_BYTES;
    const uint32_t x_bar = bars + STAGES * 8;
    // this block's tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
    const int my_tiles = (tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1;
    Ring ring{slots, bars, my_tiles * L * SLABS, L};

    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int lane = tid % 32;
    // this thread's accumulator elements: rows rbase, rbase + 8; columns
    // cbase + 8 j, + 1 for j < 32 (register 4 j + 2 h + e)
    const int rbase = 16 * ((tid % 128) / 32) + lane / 4;
    const int cbase = 256 * wg + 2 * (lane % 4);
    const AccOffsets acc_off(rbase, cbase);

    if (tid == 0) {
        for (int i = 0; i <= STAGES; ++i) mbar_init(bars + 8 * i, 1);
        mbar_init_fence();
    }
    __syncthreads();
    if (tid == 0) {
        for (int n = 0; n < STAGES && n < ring.total; ++n) issue_slab(ring, n, &w_map);
    }
    __syncwarp();

    float acc[128];
    __nv_bfloat162 res[64];  // the residual stream at this thread's accumulator elements
    int n0 = 0;              // the tile's first slab
    for (int it = 0; it < my_tiles; ++it) {
        const int row0 = (static_cast<int>(blockIdx.x) + it * static_cast<int>(gridDim.x)) * BM;
        if (tid == 0) {
            tma_store_wait_read();  // the last tile's out has left the buffer
            mbar_expect_tx(x_bar, x_bytes);
#pragma unroll
            for (int c = 0; c < C / 64; ++c) tma_load_3d(a + c * ATOM_BYTES, &x_map, x_bar, c * 64, row0, 0);
        }
        __syncwarp();
        mbar_wait(x_bar, it & 1);
#pragma unroll
        for (int k = 0; k < 64; ++k) res[k] = *reinterpret_cast<const __nv_bfloat162*>(act + acc_off(k >> 1, k & 1));

        for (int l = 0; l < L; ++l, n0 += SLABS) {
            const bool is_res = (res_bits >> l) & 1ull;
            // this layer's bias into shared memory while the tensor cores run
            if (tid < BIAS_BYTES / 16) {
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                             ::"r"(smem_u32(bias_s) + 16 * tid), "l"(bias + size_t(l) * C + 4 * tid) : "memory");
                asm volatile("cp.async.commit_group;\n" ::: "memory");
            }
            layer_gemm(acc, a, ring, n0, &w_map, tid, wg);
            // ReLU after the bf16 rounding, in bf16x2: the same values, since
            // rounding is monotonic and keeps zero; the residual add rounds
            // the exact sum once, as the plain version's f32 sum does
            const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
#pragma unroll
            for (int j = 0; j < 32; ++j) {
                const float2 bb = *reinterpret_cast<const float2*>(bias_s + cbase + 8 * j);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = 4 * j + 2 * h;
                    __nv_bfloat162 v = __hmax2(__floats2bfloat162_rn(acc[i] + bb.x, acc[i + 1] + bb.y), zero);
                    if (is_res) {
                        v = __hadd2(res[i >> 1], v);
                        res[i >> 1] = v;
                    }
                    *reinterpret_cast<__nv_bfloat162*>(act + acc_off(j, h)) = v;
                }
            }
            fence_proxy_async();
            __syncthreads();
        }
        if (tid == 0) {
#pragma unroll
            for (int c = 0; c < C / 64; ++c) tma_store_3d(&out_map, a + c * ATOM_BYTES, c * 64, row0, 0);
            tma_store_commit();
        }
    }
    if (tid == 0) tma_store_wait();
}

// The kernel's launch set-up, once per device: the shared-memory opt-in
// (cudaFuncSetAttribute) and the SM count. Returns cudaSuccess or the error.
cudaError_t setup(int* sms) {
    constexpr int MAX_DEVICES = 64;
    static int cached[MAX_DEVICES] = {};  // SMs of each device, 0 until set up
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (cached[dev] == 0) {
        err = cudaFuncSetAttribute(fused_head_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(SMEM_BYTES));
        int n = 0;
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        cached[dev] = n;
    }
    *sms = cached[dev];
    return cudaSuccess;
}

}  // namespace

extern "C" {

// x, w, out: (B, 512), (L, 512, 512), (B, 512) bf16 device pointers,
// 16-byte aligned; b: (L, 512) f32; res_after: host array of L ints.
// Launches on `stream` and returns cudaGetLastError(), cudaErrorNotSupported
// when the driver has no cuTensorMapEncodeTiled, or 10000 + the CUresult
// when it refuses a map.
int fused_head_fwd(const void* x, const void* w, const void* b, const int* res_after, void* out, int B, int L,
                   cudaStream_t stream) {
    if (B < 0 || L < 1 || L > MAX_LAYERS || res_after == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (B == 0) return 0;
    unsigned long long res_bits = 0;
    for (int l = 0; l < L; ++l) res_bits |= (res_after[l] ? 1ull : 0ull) << l;
    int sms = 0;
    const cudaError_t err = setup(&sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    // W: a slab (32 rows) a box, landing as 8 swizzled column atoms; x and
    // out: a column atom of a tile a box (rows past B read as zeros and are
    // clipped on store; with B < 64 the box has B rows, and one box of 8
    // atoms would pack them B rows apart)
    CUtensorMap w_map, x_map, out_map;
    const uint32_t tile_rows = B < BM ? static_cast<uint32_t>(B) : BM;
    CUresult r = atom_map(enc, &w_map, w, L, C, KS);
    if (r == CUDA_SUCCESS) r = layer_map(enc, &x_map, x, 1, B, 64, tile_rows, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r == CUDA_SUCCESS) r = layer_map(enc, &out_map, out, 1, B, 64, tile_rows, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
    // a persistent grid: at most one block per SM, each walking its tiles
    const int tiles = (B + BM - 1) / BM;
    const int grid = tiles < sms ? tiles : sms;
    fused_head_fwd_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(w_map, x_map, out_map, static_cast<const float*>(b),
                                                                 tiles, L, res_bits, (C / 64) * tile_rows * 128);
    return static_cast<int>(cudaGetLastError());
}

// The kernel's resources: info[0] dynamic shared bytes, [1] threads, [2] rows
// per tile, [3] registers per thread, [4] local (stack and spill) bytes per
// thread. Returns cudaFuncGetAttributes' error.
int fused_head_fwd_info(int* info) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fused_head_fwd_kernel);
    info[0] = static_cast<int>(SMEM_BYTES);
    info[1] = THREADS;
    info[2] = BM;
    info[3] = err == cudaSuccess ? a.numRegs : -1;
    info[4] = err == cudaSuccess ? static_cast<int>(a.localSizeBytes) : -1;
    return static_cast<int>(err);
}

}  // extern "C"
