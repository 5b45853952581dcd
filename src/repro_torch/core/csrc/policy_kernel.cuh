// Device runtime of the policy kernel (B1 on Hopper).
//
// Replaces the TPU kernel src/repro/core/pallasc.py:175
// (_build_pallas_fn: one pl.pallas_call running jaxc._Lowerer over the
// ctx vector and every map tile).  repro_torch/core/cudac.py emits one
// translation unit per verified program: this file, then the program's
// functions, then a <<<1,1>>> kernel and an extern "C" launcher.
//
// What bounds it on the card: not bytes or operations -- a decision
// touches a few hundred bytes and runs a few hundred integer
// instructions in one thread.  The cost is the kernel launch plus the
// copy of the ctx (and the return word) back to the host that needs the
// decision.  The design answers that: the map state stays resident on
// the device between decisions (updated in place, no per-call
// allocation or copy), the return word sits in the same buffer as the
// ctx so one device-to-host copy brings both back, and every helper is
// inlined device code here -- the host native tier calls back into
// Python for hash, LRU and ring-buffer maps, which a kernel cannot do.
//
// Semantics are the reference lowering's (jaxc), word for word, except
// the hash probe order (below, and ROADMAP C2):
//   * memory is moved as u64 words: ctx and map cells are read as the
//     8-byte word that holds the address (narrow loads mask the low
//     bytes, stores write the whole register); stack accesses shift and
//     mask within their word;
//   * hash maps: open addressing over (key_lo ^ key_hi) % cap, linear
//     probing to the first row that matches or is empty (the host map's
//     packing order; the reference's probe distance wraps in u64 and
//     misses keys past a wrap-around when cap is not a power of two);
//     a full table
//     rejects inserts (E2BIG); rows are [values..., key, used] plus the
//     occupancy cell;
//   * lru_hash maps: rows [values..., key, recency] plus the clock cell;
//     hits refresh recency, misses evict the first row of least recency;
//   * ring buffers: head / tail / drops / pending control words after
//     the record rows;
//   * ema_update: (old * (w - 1) + sample) / max(w, 1) in wrapping u64.
// BPF_DEV is a macro so the helpers also compile as host C++ for the
// CPU tests of the emitted source.

#include <stdint.h>

#ifndef BPF_DEV
#define BPF_DEV __device__ __forceinline__
#endif

typedef unsigned long long u64;

#define BPF_E2BIG 0xffffffffffffffffULL

BPF_DEV u64 bpf_ptr(const u64 *p) { return (u64)(uintptr_t)p; }
BPF_DEV u64 *bpf_at(u64 a) { return (u64 *)(uintptr_t)(a & ~7ULL); }
BPF_DEV u64 bpf_mask(int n) { return n >= 8 ? ~0ULL : (1ULL << (8 * n)) - 1; }

// ctx and map cells: the word holding the address, low bytes for
// narrow loads
BPF_DEV u64 bpf_ld_cell(u64 a, int n) { return *bpf_at(a) & bpf_mask(n); }
BPF_DEV void bpf_st_cell(u64 a, u64 v) { *bpf_at(a) = v; }

// stack: byte lanes within the word
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

BPF_DEV void bpf_copy_row(u64 *dst, u64 src, u64 slots) {
    for (u64 s = 0; s < slots; ++s) dst[s] = *bpf_at(src + 8 * s);
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
                             u64 src) {
    if (key >= rows) return BPF_E2BIG;
    bpf_copy_row(m + key * cols, src, cols);
    return 0;
}
BPF_DEV u64 bpf_array_ema(u64 *m, u64 rows, u64 cols, u64 key,
                          u64 sample, u64 weight) {
    u64 ki = key < rows ? key : rows - 1;
    u64 nv = bpf_ema(m[ki * cols], sample, weight);
    if (key < rows) m[ki * cols] = nv;
    return nv;
}

// ---- hash: [values..., key, used] rows + occupancy cell ---------------
// Sets *first to the stopping row -- the first row, walking linearly from
// the home slot, that matches the key or is empty -- and returns 1 on a
// match, 0 on an empty row, -1 when the table is full and the key absent
// (*first is then row 0).  This is the host map's own probe order
// (HashMap.to_device packs by it), so a key the host placed past a
// wrap-around is found for every capacity.
BPF_DEV int bpf_hash_probe(const u64 *m, u64 cap, u64 cols, u64 key,
                           u64 *first) {
    u64 slots = cols - 2;
    u64 r = ((key & 0xffffffffULL) ^ (key >> 32)) % cap;
    *first = 0;
    for (u64 i = 0; i < cap; ++i, r = r + 1 == cap ? 0 : r + 1) {
        const u64 *row = m + r * cols;
        if (row[slots + 1] == 0) { *first = r; return 0; }
        if (row[slots] == key) { *first = r; return 1; }
    }
    return -1;
}
BPF_DEV u64 bpf_hash_lookup(u64 *m, u64 cap, u64 cols, u64 key) {
    u64 first;
    return bpf_hash_probe(m, cap, cols, key, &first) == 1
        ? bpf_ptr(m + first * cols) : 0;
}
BPF_DEV void bpf_hash_claim(u64 *m, u64 cap, u64 cols, u64 key,
                            u64 *row, int res) {
    row[cols - 2] = key;
    row[cols - 1] = 1;
    if (res == 0) m[cap * cols] += 1;
}
BPF_DEV u64 bpf_hash_update(u64 *m, u64 cap, u64 cols, u64 key, u64 src) {
    u64 first;
    int res = bpf_hash_probe(m, cap, cols, key, &first);
    if (res < 0) return BPF_E2BIG;
    u64 *row = m + first * cols;
    bpf_copy_row(row, src, cols - 2);
    bpf_hash_claim(m, cap, cols, key, row, res);
    return 0;
}
BPF_DEV u64 bpf_hash_ema(u64 *m, u64 cap, u64 cols, u64 key, u64 sample,
                         u64 weight) {
    u64 first;
    int res = bpf_hash_probe(m, cap, cols, key, &first);
    u64 *row = m + first * cols;
    u64 nv = bpf_ema(res == 1 ? row[0] : 0, sample, weight);
    if (res < 0) return nv;
    if (res == 0)
        for (u64 s = 1; s < cols - 2; ++s) row[s] = 0;
    row[0] = nv;
    bpf_hash_claim(m, cap, cols, key, row, res);
    return nv;
}

// ---- lru_hash: [values..., key, recency] rows + clock cell ------------
BPF_DEV u64 bpf_lru_find(const u64 *m, u64 cap, u64 cols, u64 key,
                         int *found) {
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
}
BPF_DEV u64 bpf_lru_lookup(u64 *m, u64 cap, u64 cols, u64 key) {
    int found;
    u64 i = bpf_lru_find(m, cap, cols, key, &found);
    if (!found) return 0;
    u64 clock = m[cap * cols] + 1;
    m[cap * cols] = clock;
    m[i * cols + cols - 1] = clock;
    return bpf_ptr(m + i * cols);
}
BPF_DEV void bpf_lru_stamp(u64 *m, u64 cap, u64 cols, u64 key, u64 *row) {
    u64 clock = m[cap * cols] + 1;
    row[cols - 2] = key;
    row[cols - 1] = clock;
    m[cap * cols] = clock;
}
BPF_DEV u64 bpf_lru_update(u64 *m, u64 cap, u64 cols, u64 key, u64 src) {
    int found;
    u64 *row = m + bpf_lru_find(m, cap, cols, key, &found) * cols;
    bpf_copy_row(row, src, cols - 2);
    bpf_lru_stamp(m, cap, cols, key, row);
    return 0;
}
BPF_DEV u64 bpf_lru_ema(u64 *m, u64 cap, u64 cols, u64 key, u64 sample,
                        u64 weight) {
    int found;
    u64 *row = m + bpf_lru_find(m, cap, cols, key, &found) * cols;
    u64 nv = bpf_ema(found ? row[0] : 0, sample, weight);
    if (!found)
        for (u64 s = 1; s < cols - 2; ++s) row[s] = 0;
    row[0] = nv;
    bpf_lru_stamp(m, cap, cols, key, row);
    return nv;
}

// ---- ringbuf: record rows, then head / tail / drops / pending ---------
BPF_DEV u64 bpf_ringbuf_reserve(u64 *m, u64 cap, u64 slots) {
    u64 *c = m + cap * slots;
    u64 head = c[0] + c[3];
    int full = head - c[1] >= cap;
    c[0] = head;
    c[3] = full ? 0 : 1;
    if (full) { c[2] += 1; return 0; }
    return bpf_ptr(m + (head % cap) * slots);
}
BPF_DEV u64 bpf_ringbuf_submit(u64 *m, u64 cap, u64 slots) {
    u64 *c = m + cap * slots;
    c[0] += c[3];
    c[3] = 0;
    return 0;
}
BPF_DEV u64 bpf_ringbuf_discard(u64 *m, u64 cap, u64 slots) {
    m[cap * slots + 3] = 0;
    return 0;
}
