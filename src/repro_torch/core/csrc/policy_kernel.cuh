// Device runtime of the policy kernel (B1 on Hopper).
//
// Replaces the TPU kernel src/repro/core/pallasc.py:175
// (_build_pallas_fn: one pl.pallas_call running jaxc._Lowerer over the
// ctx vector and every map tile, the whole decision state in VMEM).
// repro_torch/core/cudac.py emits one translation unit per verified
// program: this file, then the program's functions, then the kernels
// and their extern "C" launchers.
//
// What bounds it on the card: not bytes or operations -- a decision
// touches a few KB at most and runs a few hundred to a few thousand
// integer instructions.  What costs is latency: the launch, and every
// load whose address or whose use waits on the one before it.  The
// design keeps that chain on the chip, as the TPU kernel kept it in
// VMEM (cudac.py's docstring has the rules and the measurements):
//   * the eBPF frame lives in registers (cudac's route "regs": every
//     stack slot a u64 local, the offsets constant by the verifier's
//     facts); route "memory" keeps a zeroed local-memory frame for a
//     function whose stack offsets are not all constant;
//   * a program with a hash or lru_hash map runs warp-uniform
//     (BPF_WARP): all 32 lanes run the same scalar code, so the hash
//     probe and the LRU scans spread rows over the lanes (a ballot finds
//     the first stopping row, a butterfly the victim), and every store
//     is made by lane 0 between two __syncwarp()s, so no lane reads a
//     cell while another writes it; any other program runs on one
//     thread (BPF_WARP 0);
//   * the ctx and the map state stay in device memory, resident between
//     decisions (updated in place) and hot in the caches; a copy into
//     shared memory at kernel start measured slower for every shipped
//     program (PERF.md, PR 25);
//   * the return word sits in the same buffer as the ctx so one
//     device-to-host copy brings both back, and every helper is inlined
//     device code here -- the host native tier calls back into Python
//     for hash, LRU and ring-buffer maps.
//
// Semantics are the reference lowering's (jaxc), word for word, except
// the hash probe order (below, and ROADMAP C2):
//   * memory is moved as u64 words: ctx and map cells are read as the
//     8-byte word that holds the address (narrow loads mask the low
//     bytes, stores write the whole register); stack accesses shift and
//     mask within their word;
//   * hash maps: open addressing over (key_lo ^ key_hi) % cap (one
//     32-bit remainder: the folded key and cap are below 2^32), linear
//     probing to the first row that matches or is empty (the host map's
//     packing order; the reference's probe distance wraps in u64 and
//     misses keys past a wrap-around when cap is not a power of two);
//     a full table rejects inserts (E2BIG); rows are [values..., key,
//     used] plus the occupancy cell;
//   * lru_hash maps: rows [values..., key, recency] plus the clock cell;
//     hits refresh recency, misses evict the first row of least recency;
//   * ring buffers: head / tail / drops / pending control words after
//     the record rows;
//   * ema_update: (old * (w - 1) + sample) / max(w, 1) in wrapping u64.
// BPF_DEV is a macro so the helpers also compile as host C++ for the
// CPU tests of the emitted source, where BPF_KERNEL and BPF_WARP are 0
// (one host thread, the serial scans); tests/cuda_emu/ runs the kernel
// half, warp-uniform, on the CPU.

#include <stdint.h>

#ifndef BPF_DEV
#define BPF_DEV __device__ __forceinline__
#endif

// BPF_KERNEL: the kernel half is compiled (under nvcc, or the CPU
// emulation of tests/cuda_emu/); BPF_WARP: the decision runs
// warp-uniform (cudac emits "#define BPF_WARP 0" before this file for a
// decision on one thread)
#ifndef BPF_KERNEL
#ifdef __CUDACC__
#define BPF_KERNEL 1
#else
#define BPF_KERNEL 0
#endif
#endif
#ifndef BPF_WARP
#define BPF_WARP BPF_KERNEL
#endif

typedef unsigned long long u64;

#define BPF_E2BIG 0xffffffffffffffffULL

BPF_DEV u64 bpf_ptr(const u64 *p) { return (u64)(uintptr_t)p; }
BPF_DEV u64 *bpf_at(u64 a) { return (u64 *)(uintptr_t)(a & ~7ULL); }
BPF_DEV u64 bpf_mask(int n) { return n >= 8 ? ~0ULL : (1ULL << (8 * n)) - 1; }

// Stores of a warp-uniform decision: every lane has read what it needs,
// lane 0 writes, and every lane sees the write after bpf_wend().
//   if (bpf_wbegin()) { ...stores... } bpf_wend();
#if BPF_WARP
BPF_DEV bool bpf_wbegin() { __syncwarp(); return (threadIdx.x & 31) == 0; }
BPF_DEV void bpf_wend() { __syncwarp(); }
#else
BPF_DEV bool bpf_wbegin() { return true; }
BPF_DEV void bpf_wend() {}
#endif

// ctx and map cells: the word holding the address, low bytes for
// narrow loads
BPF_DEV u64 bpf_ld_cell(u64 a, int n) { return *bpf_at(a) & bpf_mask(n); }
BPF_DEV void bpf_st_cell(u64 a, u64 v) {
    if (bpf_wbegin()) *bpf_at(a) = v;
    bpf_wend();
}

// stack (route "memory"): byte lanes within the word.  The frame is
// per thread, so its stores need no lane-0 discipline.
BPF_DEV u64 bpf_ld_stack(u64 a, int n) {
    u64 w = *bpf_at(a);
    if (n >= 8) return w;
    return (w >> ((a & 7) * 8)) & bpf_mask(n);
}
BPF_DEV void bpf_st_stack(u64 a, int n, u64 v) {
    u64 *p = bpf_at(a);
    if (n >= 8) { *p = v; return; }
    u64 sh = (a & 7) * 8, m = bpf_mask(n);
    *p = (*p & ~(m << sh)) | ((v & m) << sh);
}

// src: the value words (a map row, the memory frame, or the register
// slots gathered into a local array by the caller)
BPF_DEV void bpf_copy_row(u64 *dst, const u64 *src, u64 slots) {
    if (bpf_wbegin())
        for (u64 s = 0; s < slots; ++s) dst[s] = src[s];
    bpf_wend();
}

BPF_DEV u64 bpf_ema(u64 old, u64 sample, u64 weight) {
    u64 w = weight ? weight : 1;
    return (old * (w - 1) + sample) / w;
}

// ---- array / perdev_array: rows of value slots ------------------------
BPF_DEV u64 bpf_array_lookup(u64 *m, u64 rows, u64 cols, u64 key) {
    return key < rows ? bpf_ptr(m + key * cols) : 0;
}
BPF_DEV u64 bpf_array_update(u64 *m, u64 rows, u64 cols, u64 key,
                             const u64 *src) {
    if (key >= rows) return BPF_E2BIG;
    bpf_copy_row(m + key * cols, src, cols);
    return 0;
}
BPF_DEV u64 bpf_array_ema(u64 *m, u64 rows, u64 cols, u64 key,
                          u64 sample, u64 weight) {
    u64 ki = key < rows ? key : rows - 1;
    u64 nv = bpf_ema(m[ki * cols], sample, weight);
    if (bpf_wbegin() && key < rows) m[ki * cols] = nv;
    bpf_wend();
    return nv;
}

// ---- hash: [values..., key, used] rows + occupancy cell ---------------
// The home slot: (key_lo ^ key_hi) is below 2^32, and so is cap (a
// u32 max_entries), so one 32-bit remainder gives the u64 one.
BPF_DEV u64 bpf_hash_home(u64 key, u64 cap) {
    return (uint32_t)((key & 0xffffffffULL) ^ (key >> 32)) % (uint32_t)cap;
}
// Sets *first to the stopping row -- the first row, walking linearly from
// the home slot, that matches the key or is empty -- and returns 1 on a
// match, 0 on an empty row, -1 when the table is full and the key absent
// (*first is then row 0).  This is the host map's own probe order
// (HashMap.to_device packs by it), so a key the host placed past a
// wrap-around is found for every capacity.  Warp-uniform, lane l looks
// at the l-th row of each 32-row window of the walk; the lowest lane
// whose row stops the walk is the serial walk's stop.
BPF_DEV int bpf_hash_probe(const u64 *m, u64 cap, u64 cols, u64 key,
                           u64 *first) {
    u64 slots = cols - 2;
    u64 home = bpf_hash_home(key, cap);
    *first = 0;
#if BPF_WARP
    unsigned lane = threadIdx.x & 31;
    for (u64 base = 0; base < cap; base += 32) {
        u64 i = base + lane, r = home + i;
        if (r >= cap) r -= cap;
        bool empty = false, stop = false;
        if (i < cap) {
            const u64 *row = m + r * cols;
            empty = row[slots + 1] == 0;
            stop = empty || row[slots] == key;
        }
        unsigned hit = __ballot_sync(0xffffffffu, stop);
        if (hit) {
            int l = __ffs(hit) - 1;
            u64 rs = home + base + l;
            *first = rs >= cap ? rs - cap : rs;
            return __shfl_sync(0xffffffffu, (int)empty, l) ? 0 : 1;
        }
    }
    return -1;
#else
    u64 r = home;
    for (u64 i = 0; i < cap; ++i, r = r + 1 == cap ? 0 : r + 1) {
        const u64 *row = m + r * cols;
        if (row[slots + 1] == 0) { *first = r; return 0; }
        if (row[slots] == key) { *first = r; return 1; }
    }
    return -1;
#endif
}
BPF_DEV u64 bpf_hash_lookup(u64 *m, u64 cap, u64 cols, u64 key) {
    u64 first;
    return bpf_hash_probe(m, cap, cols, key, &first) == 1
        ? bpf_ptr(m + first * cols) : 0;
}
// (inside a bpf_wbegin() block)
BPF_DEV void bpf_hash_claim(u64 *m, u64 cap, u64 cols, u64 key,
                            u64 *row, int res) {
    row[cols - 2] = key;
    row[cols - 1] = 1;
    if (res == 0) m[cap * cols] += 1;
}
BPF_DEV u64 bpf_hash_update(u64 *m, u64 cap, u64 cols, u64 key,
                            const u64 *src) {
    u64 first;
    int res = bpf_hash_probe(m, cap, cols, key, &first);
    if (res < 0) return BPF_E2BIG;
    u64 *row = m + first * cols;
    if (bpf_wbegin()) {
        for (u64 s = 0; s < cols - 2; ++s) row[s] = src[s];
        bpf_hash_claim(m, cap, cols, key, row, res);
    }
    bpf_wend();
    return 0;
}
BPF_DEV u64 bpf_hash_ema(u64 *m, u64 cap, u64 cols, u64 key, u64 sample,
                         u64 weight) {
    u64 first;
    int res = bpf_hash_probe(m, cap, cols, key, &first);
    u64 *row = m + first * cols;
    u64 nv = bpf_ema(res == 1 ? row[0] : 0, sample, weight);
    if (res < 0) return nv;
    if (bpf_wbegin()) {
        if (res == 0)
            for (u64 s = 1; s < cols - 2; ++s) row[s] = 0;
        row[0] = nv;
        bpf_hash_claim(m, cap, cols, key, row, res);
    }
    bpf_wend();
    return nv;
}

// ---- lru_hash: [values..., key, recency] rows + clock cell ------------
// The first live row holding the key, else the victim: the lowest index
// of least recency.  Warp-uniform, a ballot over each 32-row window
// finds the first match, and each lane's (recency, index) minimum over
// its rows meets the others' in a butterfly, lexicographically.
BPF_DEV u64 bpf_lru_find(const u64 *m, u64 cap, u64 cols, u64 key,
                         int *found) {
#if BPF_WARP
    unsigned lane = threadIdx.x & 31;
    for (u64 base = 0; base < cap; base += 32) {
        u64 i = base + lane;
        bool hit = false;
        if (i < cap) {
            const u64 *row = m + i * cols;
            hit = row[cols - 1] != 0 && row[cols - 2] == key;
        }
        unsigned b = __ballot_sync(0xffffffffu, hit);
        if (b) {
            *found = 1;
            return base + __ffs(b) - 1;
        }
    }
    u64 best = ~0ULL, at = ~0ULL;
    for (u64 i = lane; i < cap; i += 32) {
        u64 rec = m[i * cols + cols - 1];
        if (at == ~0ULL || rec < best) { best = rec; at = i; }
    }
    for (int d = 16; d > 0; d >>= 1) {
        u64 ob = __shfl_xor_sync(0xffffffffu, best, d);
        u64 oa = __shfl_xor_sync(0xffffffffu, at, d);
        if (ob < best || (ob == best && oa < at)) { best = ob; at = oa; }
    }
    *found = 0;
    return at;
#else
    for (u64 i = 0; i < cap; ++i) {
        const u64 *row = m + i * cols;
        if (row[cols - 1] != 0 && row[cols - 2] == key) {
            *found = 1;
            return i;
        }
    }
    u64 victim = 0;
    for (u64 i = 1; i < cap; ++i)
        if (m[i * cols + cols - 1] < m[victim * cols + cols - 1]) victim = i;
    *found = 0;
    return victim;
#endif
}
BPF_DEV u64 bpf_lru_lookup(u64 *m, u64 cap, u64 cols, u64 key) {
    int found;
    u64 i = bpf_lru_find(m, cap, cols, key, &found);
    if (!found) return 0;
    u64 clock = m[cap * cols] + 1;
    if (bpf_wbegin()) {
        m[cap * cols] = clock;
        m[i * cols + cols - 1] = clock;
    }
    bpf_wend();
    return bpf_ptr(m + i * cols);
}
// (inside a bpf_wbegin() block)
BPF_DEV void bpf_lru_stamp(u64 *m, u64 cap, u64 cols, u64 key, u64 *row,
                           u64 clock) {
    row[cols - 2] = key;
    row[cols - 1] = clock;
    m[cap * cols] = clock;
}
BPF_DEV u64 bpf_lru_update(u64 *m, u64 cap, u64 cols, u64 key,
                           const u64 *src) {
    int found;
    u64 *row = m + bpf_lru_find(m, cap, cols, key, &found) * cols;
    u64 clock = m[cap * cols] + 1;
    if (bpf_wbegin()) {
        for (u64 s = 0; s < cols - 2; ++s) row[s] = src[s];
        bpf_lru_stamp(m, cap, cols, key, row, clock);
    }
    bpf_wend();
    return 0;
}
BPF_DEV u64 bpf_lru_ema(u64 *m, u64 cap, u64 cols, u64 key, u64 sample,
                        u64 weight) {
    int found;
    u64 *row = m + bpf_lru_find(m, cap, cols, key, &found) * cols;
    u64 nv = bpf_ema(found ? row[0] : 0, sample, weight);
    u64 clock = m[cap * cols] + 1;
    if (bpf_wbegin()) {
        if (!found)
            for (u64 s = 1; s < cols - 2; ++s) row[s] = 0;
        row[0] = nv;
        bpf_lru_stamp(m, cap, cols, key, row, clock);
    }
    bpf_wend();
    return nv;
}

// ---- ringbuf: record rows, then head / tail / drops / pending ---------
BPF_DEV u64 bpf_ringbuf_reserve(u64 *m, u64 cap, u64 slots) {
    u64 *c = m + cap * slots;
    u64 head = c[0] + c[3];
    int full = head - c[1] >= cap;
    u64 drops = c[2] + 1;
    if (bpf_wbegin()) {
        c[0] = head;
        c[3] = full ? 0 : 1;
        if (full) c[2] = drops;
    }
    bpf_wend();
    if (full) return 0;
    return bpf_ptr(m + (head % cap) * slots);
}
BPF_DEV u64 bpf_ringbuf_submit(u64 *m, u64 cap, u64 slots) {
    u64 *c = m + cap * slots;
    u64 head = c[0] + c[3];
    if (bpf_wbegin()) {
        c[0] = head;
        c[3] = 0;
    }
    bpf_wend();
    return 0;
}
BPF_DEV u64 bpf_ringbuf_discard(u64 *m, u64 cap, u64 slots) {
    if (bpf_wbegin()) m[cap * slots + 3] = 0;
    bpf_wend();
    return 0;
}
