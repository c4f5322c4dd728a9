// warp_emu.h — a CPU stand-in for the CUDA features csrc/ring_search.cu
// uses, so that the kernel's logic can be compiled with g++ and run on CPU
// tensors (tests/test_torch_kernel_emulated.py).  A block runs as blockDim.x
// OS threads, its blocks one after another; each warp intrinsic (shuffle,
// ballot, vote, match, reduce, __syncwarp) is an exchange through a buffer
// of the warp between two barriers, so threads run independently between
// intrinsics, as on a card with independent thread scheduling.  Event
// records and launches are logged in order (emu_trace).  Peer access is a
// table of EMU_NDEV cards, each able to reach every other, with the
// runtime's last-error rule: enabling a pair twice fails with
// cudaErrorPeerAccessAlreadyEnabled and leaves that error for the next
// cudaGetLastError.  It says nothing of speed, registers or the card's
// memory model beyond that.
#pragma once
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(n) alignas(n)
#define __grid_constant__
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx, blockIdx, blockDim;
struct int2 { int x, y; };
struct alignas(16) int4 { int x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
typedef void* cudaStream_t;
typedef void* cudaEvent_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaErrorInvalidDevice = 101, cudaErrorPeerAccessUnsupported = 217,
       cudaErrorPeerAccessAlreadyEnabled = 704 };
inline int emu_last_error = 0;
inline int cudaGetLastError() { int e = emu_last_error; emu_last_error = 0; return e; }
inline const char* cudaGetErrorString(int e) {
    return e == 0 ? "no error" : e == cudaErrorInvalidDevice ? "invalid device ordinal"
         : e == cudaErrorPeerAccessUnsupported ? "peer access is not supported between these two devices"
         : e == cudaErrorPeerAccessAlreadyEnabled ? "peer access is already enabled" : "unknown error";
}
#define EMU_NDEV 4
inline int emu_device = 0;
inline bool emu_peer[EMU_NDEV][EMU_NDEV];
extern "C" int emu_current_device() { return emu_device; }
inline int cudaGetDevice(int* d) { *d = emu_device; return 0; }
inline int cudaSetDevice(int d) {
    if (d < 0 || d >= EMU_NDEV) return emu_last_error = cudaErrorInvalidDevice;
    emu_device = d;
    return 0;
}
inline int cudaDeviceCanAccessPeer(int* can, int d, int p) {
    if (d < 0 || d >= EMU_NDEV || p < 0 || p >= EMU_NDEV) return emu_last_error = cudaErrorInvalidDevice;
    *can = d != p;
    return 0;
}
inline int cudaDeviceEnablePeerAccess(int p, unsigned) {
    if (p < 0 || p >= EMU_NDEV || p == emu_device) return emu_last_error = cudaErrorInvalidDevice;
    if (emu_peer[emu_device][p]) return emu_last_error = cudaErrorPeerAccessAlreadyEnabled;
    emu_peer[emu_device][p] = true;
    return 0;
}
// what ran, in order: "r<n>" a record of the event whose handle is n (0-9),
// "k" a kernel launch
inline std::string emu_log;
extern "C" const char* emu_trace() { return emu_log.c_str(); }
inline int cudaEventRecord(cudaEvent_t e, cudaStream_t) {
    emu_log += "r" + std::to_string((uintptr_t)e % 10);
    return 0;
}
template <class F> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }

struct EmuWarp {
    std::barrier<> bar{32};
    uint64_t buf[32];
};
inline thread_local EmuWarp* emu_w = nullptr;
inline thread_local unsigned char* emu_sm = nullptr;
inline int emu_lane() { return threadIdx.x & 31; }
template <class T> inline uint64_t emu_bits(T v) { uint64_t b = 0; std::memcpy(&b, &v, sizeof(T)); return b; }
template <class T> inline T emu_from(uint64_t b) { T v; std::memcpy(&v, &b, sizeof(T)); return v; }
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { std::atomic_thread_fence(std::memory_order_seq_cst); emu_w->bar.arrive_and_wait(); }
template <class T> inline T emu_xchg(T v, int src) {
    emu_w->buf[emu_lane()] = emu_bits(v);
    emu_w->bar.arrive_and_wait();
    T r = emu_from<T>(emu_w->buf[src & 31]);
    emu_w->bar.arrive_and_wait();
    return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return emu_xchg(v, src); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) { return emu_xchg(v, emu_lane() ^ m); }
inline unsigned emu_gather_bits(bool p) {
    emu_w->buf[emu_lane()] = p;
    emu_w->bar.arrive_and_wait();
    unsigned r = 0;
    for (int i = 0; i < 32; i++) r |= (unsigned)(emu_w->buf[i] & 1) << i;
    emu_w->bar.arrive_and_wait();
    return r;
}
inline unsigned __ballot_sync(unsigned, int p) { return emu_gather_bits(p != 0); }
inline bool __any_sync(unsigned, int p) { return emu_gather_bits(p != 0) != 0; }
inline unsigned __match_any_sync(unsigned, int v) {
    emu_w->buf[emu_lane()] = (uint64_t)(uint32_t)v;
    emu_w->bar.arrive_and_wait();
    unsigned r = 0;
    for (int i = 0; i < 32; i++) r |= (unsigned)(emu_w->buf[i] == (uint64_t)(uint32_t)v) << i;
    emu_w->bar.arrive_and_wait();
    return r;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
    emu_w->buf[emu_lane()] = v;
    emu_w->bar.arrive_and_wait();
    unsigned r = 0xFFFFFFFFu;
    for (int i = 0; i < 32; i++) r = (unsigned)emu_w->buf[i] < r ? (unsigned)emu_w->buf[i] : r;
    emu_w->bar.arrive_and_wait();
    return r;
}
inline int __reduce_add_sync(unsigned, int v) {
    emu_w->buf[emu_lane()] = (uint64_t)(uint32_t)v;
    emu_w->bar.arrive_and_wait();
    unsigned r = 0;
    for (int i = 0; i < 32; i++) r += (unsigned)emu_w->buf[i];
    emu_w->bar.arrive_and_wait();
    return (int)r;
}
// run a "kernel" over `blocks` blocks of `threads` threads, blocks in turn
template <class K, class... A>
void emu_launch(K kern, int blocks, int threads, size_t smem, A... args) {
    emu_log += "k";
    for (int b = 0; b < blocks; b++) {
        std::vector<unsigned char> sm(smem + 16);
        std::vector<EmuWarp> warps(threads / 32);
        std::vector<std::thread> th;
        for (int i = 0; i < threads; i++)
            th.emplace_back([&, i] {
                threadIdx.x = i; blockIdx.x = b; blockDim.x = threads;
                emu_w = &warps[i / 32];
                emu_sm = sm.data();
                kern(args...);
            });
        for (auto& x : th) x.join();
    }
}
