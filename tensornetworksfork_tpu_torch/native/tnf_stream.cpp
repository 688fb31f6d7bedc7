// Native shuffled-minibatch streamer: a background worker thread gathers
// seeded-permutation minibatches from a host-resident array (or an mmap'd
// file, for bigger-than-RAM datasets) into a ring of staging buffers while
// the consumer trains on the previous batch, so the host-side gather runs in
// the shadow of device compute. Used by utils/data_stream.py's
// MinibatchStream, which models/module.py's TensorTrainBatchRegressor
// (stream="native") reads. The same source as
// tensornetworksfork_tpu/native/tnf_stream.cpp, so one seed gives one
// permutation sequence (mt19937_64, Fisher-Yates) in both packages.
//
// C API (ctypes, see native/__init__.py):
//   tnf_stream_open_mem(base, n, sample_bytes, batch, seed, nbuf) -> handle
//   tnf_stream_open_file(path, offset, n, sample_bytes, batch, seed, nbuf)
//   tnf_stream_next(handle, dst, idx_out) -> rows in this batch (>0 always;
//       epochs wrap with a fresh permutation; partial tail batch kept)
//   tnf_stream_close(handle)
// All functions return <0 on error.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Slot {
    std::vector<uint8_t> data;
    std::vector<long> idx;
    long rows = 0;
    bool ready = false;
};

struct Stream {
    const uint8_t* base = nullptr;
    long n = 0, sample_bytes = 0, batch = 0;
    // file-backed state (mem streams leave fd = -1)
    int fd = -1;
    void* map = nullptr;
    size_t map_len = 0;

    std::vector<Slot> slots;
    size_t head = 0, tail = 0;  // producer / consumer slot cursors
    std::mutex m;
    std::condition_variable cv_prod, cv_cons;
    bool stop = false;
    std::mt19937_64 rng;
    std::thread worker;

    ~Stream() {
        {
            std::lock_guard<std::mutex> lk(m);
            stop = true;
        }
        cv_prod.notify_all();
        cv_cons.notify_all();
        if (worker.joinable()) worker.join();
        if (map) munmap(map, map_len);
        if (fd >= 0) close(fd);
    }
};

std::mutex g_reg_m;
std::unordered_map<long, Stream*> g_reg;
long g_next_handle = 1;

void worker_loop(Stream* s) {
    std::vector<long> perm(s->n);
    for (long i = 0; i < s->n; ++i) perm[i] = i;
    for (;;) {
        // fresh epoch permutation (Fisher-Yates, seeded mt19937_64)
        for (long i = s->n - 1; i > 0; --i) {
            long j = (long)(s->rng() % (uint64_t)(i + 1));
            std::swap(perm[i], perm[j]);
        }
        for (long pos = 0; pos < s->n; pos += s->batch) {
            long rows = std::min(s->batch, s->n - pos);
            Slot* slot;
            {
                std::unique_lock<std::mutex> lk(s->m);
                s->cv_prod.wait(lk, [s] {
                    return s->stop || !s->slots[s->head].ready;
                });
                if (s->stop) return;
                slot = &s->slots[s->head];
            }
            // gather outside the lock: the consumer never touches a
            // non-ready slot
            for (long r = 0; r < rows; ++r) {
                long src = perm[pos + r];
                std::memcpy(slot->data.data() + (size_t)r * s->sample_bytes,
                            s->base + (size_t)src * s->sample_bytes,
                            (size_t)s->sample_bytes);
                slot->idx[r] = src;
            }
            slot->rows = rows;
            {
                std::lock_guard<std::mutex> lk(s->m);
                slot->ready = true;
                s->head = (s->head + 1) % s->slots.size();
            }
            s->cv_cons.notify_one();
        }
    }
}

long register_stream(Stream* s, long batch, unsigned long seed, int nbuf) {
    if (nbuf < 2) nbuf = 2;
    s->slots.resize(nbuf);
    for (auto& slot : s->slots) {
        slot.data.resize((size_t)batch * s->sample_bytes);
        slot.idx.resize(batch);
    }
    s->rng.seed(seed);
    s->worker = std::thread(worker_loop, s);
    std::lock_guard<std::mutex> lk(g_reg_m);
    long h = g_next_handle++;
    g_reg[h] = s;
    return h;
}

Stream* lookup(long h) {
    std::lock_guard<std::mutex> lk(g_reg_m);
    auto it = g_reg.find(h);
    return it == g_reg.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

long tnf_stream_open_mem(const void* base, long n, long sample_bytes,
                         long batch, unsigned long seed, int nbuf) {
    if (!base || n <= 0 || sample_bytes <= 0 || batch <= 0) return -1;
    Stream* s = new Stream();
    s->base = (const uint8_t*)base;
    s->n = n;
    s->sample_bytes = sample_bytes;
    s->batch = std::min(batch, n);
    return register_stream(s, s->batch, seed, nbuf);
}

long tnf_stream_open_file(const char* path, long offset, long n,
                          long sample_bytes, long batch, unsigned long seed,
                          int nbuf) {
    if (!path || n <= 0 || sample_bytes <= 0 || batch <= 0 || offset < 0)
        return -1;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -2;
    struct stat st;
    if (fstat(fd, &st) != 0 ||
        (long)st.st_size < offset + n * sample_bytes) {
        close(fd);
        return -3;
    }
    void* map = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE,
                     fd, 0);
    if (map == MAP_FAILED) {
        close(fd);
        return -4;
    }
    Stream* s = new Stream();
    s->fd = fd;
    s->map = map;
    s->map_len = (size_t)st.st_size;
    s->base = (const uint8_t*)map + offset;
    s->n = n;
    s->sample_bytes = sample_bytes;
    s->batch = std::min(batch, n);
    return register_stream(s, s->batch, seed, nbuf);
}

long tnf_stream_next(long h, void* dst, long* idx_out) {
    Stream* s = lookup(h);
    if (!s || !dst) return -1;
    Slot* slot;
    {
        std::unique_lock<std::mutex> lk(s->m);
        s->cv_cons.wait(lk, [s] {
            return s->stop || s->slots[s->tail].ready;
        });
        if (s->stop) return -2;
        slot = &s->slots[s->tail];
    }
    long rows = slot->rows;
    std::memcpy(dst, slot->data.data(), (size_t)rows * s->sample_bytes);
    if (idx_out)
        std::memcpy(idx_out, slot->idx.data(), (size_t)rows * sizeof(long));
    {
        std::lock_guard<std::mutex> lk(s->m);
        slot->ready = false;
        s->tail = (s->tail + 1) % s->slots.size();
    }
    s->cv_prod.notify_one();
    return rows;
}

void tnf_stream_close(long h) {
    Stream* s = nullptr;
    {
        std::lock_guard<std::mutex> lk(g_reg_m);
        auto it = g_reg.find(h);
        if (it != g_reg.end()) {
            s = it->second;
            g_reg.erase(it);
        }
    }
    delete s;  // ~Stream joins the worker and unmaps
}

}  // extern "C"
