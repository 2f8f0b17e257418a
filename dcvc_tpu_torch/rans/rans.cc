// dcvc_tpu host-side rANS entropy coder.
//
// A fresh TPU-host implementation, stream-format compatible with the
// reference coder (microsoft/DCVC src/cpp/py_rans: rans.cpp, py_rans.cpp):
//   * 32-bit rANS state, 16-bit frequency scale, byte renormalization with
//     lower bound 2^23, encoder writes the buffer backwards.
//   * symbols are zig-zag folded (0, +1, -1, ...); values >= max_value
//     escape to a 2-bit bypass mode with a unary-ish bypass-count prefix.
//   * two CDF banks: bank 0 = z (factorized prior, indexed (i % ch) +
//     cdf_offset), bank 1 = y (indexed by a per-symbol uint8 cdf index
//     packed with the symbol into an int16 "combined symbol").
//   * up to 8 parallel lanes; lane pairs are merged forward + byte-reversed
//     with shared-trailing-zero overlap and an int32 cumulative-offset
//     header when n >= 3.
//
// Exposed as a plain C API for ctypes (no pybind11 dependency).

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

constexpr int kScaleBits = 16;
constexpr int kShiftBits = 23;
constexpr uint32_t kRansL = 1u << kShiftBits;
constexpr int kEncRenormShift = kShiftBits - kScaleBits + 8;
constexpr uint32_t kDecMask = (1u << kScaleBits) - 1;
constexpr int kBypassBits = 2;
constexpr uint32_t kMaxBypassVal = (1u << kBypassBits) - 1;
constexpr int kMaxParallel = 8;
// initial per-lane backing store; EncLane::ensure_headroom grows it on
// demand, so this only sets the no-realloc fast-path capacity
constexpr int kLaneBufferSize = 1 << 20;

struct CdfEntry {
    uint16_t start;
    uint16_t range;
};

struct CdfBank {
    // flattened (n_cdf, per_size) int32 CDF rows
    std::vector<int32_t> cdf;
    std::vector<CdfEntry> sym;  // same layout, per-symbol (start, range)
    std::vector<int8_t> max_value;
    int per_size = 0;
    int n_cdf = 0;

    void set(const int32_t* cdfs, int n, int per, const int32_t* sizes) {
        n_cdf = n;
        per_size = per;
        cdf.assign(cdfs, cdfs + static_cast<size_t>(n) * per);
        max_value.resize(n);
        sym.resize(static_cast<size_t>(n) * per);
        for (int i = 0; i < n; i++) {
            max_value[i] = static_cast<int8_t>(sizes[i] - 2);
            const int32_t* row = cdfs + static_cast<size_t>(i) * per;
            CdfEntry* srow = sym.data() + static_cast<size_t>(i) * per;
            for (int j = 0; j < per - 1; j++) {
                srow[j].start = static_cast<uint16_t>(row[j]);
                srow[j].range = static_cast<uint16_t>(row[j + 1] - row[j]);
            }
        }
    }
};

// ---------------------------------------------------------------- encoding

inline void enc_put(uint32_t& st, uint8_t*& ptr, uint32_t start, uint32_t freq) {
    const uint32_t st_max = freq << kEncRenormShift;
    while (st >= st_max) {
        *(--ptr) = static_cast<uint8_t>(st);
        st >>= 8;
    }
    st = ((st / freq) << kScaleBits) + (st % freq) + start;
}

inline void enc_put_bits(uint32_t& st, uint8_t*& ptr, uint32_t val) {
    constexpr uint32_t freq = 1u << (kScaleBits - kBypassBits);
    constexpr uint32_t st_max = freq << kEncRenormShift;
    while (st >= st_max) {
        *(--ptr) = static_cast<uint8_t>(st);
        st >>= 8;
    }
    st = (st << kBypassBits) | val;
}

inline void enc_symbol(uint32_t& st, uint8_t*& ptr, int32_t s, int8_t max_value,
                       const CdfEntry* row) {
    int32_t value = (s < 0 ? -s : s) * 2 - (s > 0);
    if (value >= max_value) {
        const uint32_t raw = static_cast<uint32_t>(value - max_value);
        value = max_value;
        // bypass chunks are emitted through rANS in reverse, so stage them
        uint16_t bins[40];
        int nbins = 0;
        int32_t n_bypass = 0;
        while ((raw >> (n_bypass * kBypassBits)) != 0) n_bypass++;
        int32_t v = n_bypass;
        while (v >= static_cast<int32_t>(kMaxBypassVal)) {
            bins[nbins++] = static_cast<uint16_t>(kMaxBypassVal);
            v -= kMaxBypassVal;
        }
        bins[nbins++] = static_cast<uint16_t>(v);
        for (int32_t j = 0; j < n_bypass; j++) {
            bins[nbins++] = static_cast<uint16_t>((raw >> (j * kBypassBits)) & kMaxBypassVal);
        }
        for (int j = nbins - 1; j >= 0; j--) {
            enc_put_bits(st, ptr, bins[j]);
        }
    }
    enc_put(st, ptr, row[value].start, row[value].range);
}

// ---------------------------------------------------------------- decoding

inline uint32_t dec_get_bits(uint32_t& st, const uint8_t*& ptr) {
    uint32_t val = st & kMaxBypassVal;
    st >>= kBypassBits;
    if (st < kRansL) {
        st = (st << 8) | *ptr++;
    }
    return val;
}

inline int8_t dec_symbol(uint32_t& st, const uint8_t*& ptr, const int32_t* cdf,
                         int8_t max_value) {
    const int32_t cum = static_cast<int32_t>(st & kDecMask);
    int s = 1;
    while (cdf[s] <= cum) s++;
    s--;
    // advance
    st = static_cast<uint32_t>(cdf[s + 1] - cdf[s]) * (st >> kScaleBits) + (st & kDecMask)
         - static_cast<uint32_t>(cdf[s]);
    while (st < kRansL) {
        st = (st << 8) | *ptr++;
    }

    int32_t value = s;
    if (value == max_value) {
        uint32_t val = dec_get_bits(st, ptr);
        int32_t n_bypass = static_cast<int32_t>(val);
        while (val == kMaxBypassVal) {
            val = dec_get_bits(st, ptr);
            n_bypass += static_cast<int32_t>(val);
        }
        int32_t raw = 0;
        for (int j = 0; j < n_bypass; j++) {
            raw |= static_cast<int32_t>(dec_get_bits(st, ptr)) << (j * kBypassBits);
        }
        value = raw + max_value;
    }
    return static_cast<int8_t>((value % 2 == 1) ? (value + 1) / 2 : -(value + 1) / 2);
}

// ------------------------------------------------------------- worker lane

// A lane owns one rANS state + buffer and a worker thread consuming a task
// queue, so entropy work overlaps TPU dispatch on the host side (the role
// of the std::thread per RansEncoderLib in the reference).
class Lane {
public:
    Lane() : thread_([this] { run(); }) {}

    ~Lane() {
        {
            std::lock_guard<std::mutex> lk(mu_);
            finish_ = true;
        }
        cv_.notify_all();
        thread_.join();
    }

    void post(std::function<void()> task) {
        {
            std::lock_guard<std::mutex> lk(mu_);
            tasks_.push(std::move(task));
            done_ = false;
        }
        cv_.notify_one();
    }

    void wait() {
        std::unique_lock<std::mutex> lk(mu_);
        cv_done_.wait(lk, [this] { return done_; });
    }

private:
    void run() {
        for (;;) {
            std::function<void()> task;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_.wait(lk, [this] { return finish_ || !tasks_.empty(); });
                if (finish_ && tasks_.empty()) return;
                task = std::move(tasks_.front());
                tasks_.pop();
            }
            task();
            {
                std::lock_guard<std::mutex> lk(mu_);
                if (tasks_.empty()) {
                    done_ = true;
                    cv_done_.notify_all();
                }
            }
        }
    }

    std::mutex mu_;
    std::condition_variable cv_, cv_done_;
    std::queue<std::function<void()>> tasks_;
    bool finish_ = false;
    bool done_ = true;
    std::thread thread_;
};

struct EncLane {
    std::vector<uint8_t> buffer;
    uint8_t* ptr = nullptr;
    uint32_t state = kRansL;
    std::vector<uint8_t> out;
    Lane worker;

    EncLane() : buffer(kLaneBufferSize) { reset(); }

    void reset() {
        state = kRansL;
        ptr = buffer.data() + buffer.size();
        out.clear();
    }

    // The encoder walks the buffer BACKWARD; a pathological high-entropy
    // input could otherwise run past the front.  Called once per symbol
    // (one compare in the common case); grows by doubling, moving the
    // already-written tail to the end of the new buffer.
    void ensure_headroom() {
        if (ptr - buffer.data() >= 64) return;
        const size_t used =
            static_cast<size_t>(buffer.data() + buffer.size() - ptr);
        std::vector<uint8_t> bigger(buffer.size() * 2);
        std::memcpy(bigger.data() + bigger.size() - used, ptr, used);
        buffer = std::move(bigger);
        ptr = buffer.data() + buffer.size() - used;
    }

    void flush() {
        ptr -= 4;
        ptr[0] = static_cast<uint8_t>(state >> 0);
        ptr[1] = static_cast<uint8_t>(state >> 8);
        ptr[2] = static_cast<uint8_t>(state >> 16);
        ptr[3] = static_cast<uint8_t>(state >> 24);
        out.assign(ptr, buffer.data() + buffer.size());
    }
};

struct DecLane {
    std::vector<uint8_t> stream;
    const uint8_t* ptr = nullptr;
    uint32_t state = 0;
    Lane worker;

    void set_stream(std::vector<uint8_t> s) {
        stream = std::move(s);
        ptr = stream.data();
        state = static_cast<uint32_t>(ptr[0]) | (static_cast<uint32_t>(ptr[1]) << 8) |
                (static_cast<uint32_t>(ptr[2]) << 16) | (static_cast<uint32_t>(ptr[3]) << 24);
        ptr += 4;
    }
};

// --------------------------------------------- indexed (legacy-family) mode
//
// The pre-UF family (DCVC/TCM/HEM/DC/FM/EVC) codes DENSE symbol grids with
// a per-symbol CDF row index and per-row integer offsets (reference
// DCVC-family/DCVC-FM/src/cpp/rans/rans.cpp encode_with_indexes):
// value = symbol - offset[idx]; negative values fold to -2v-1 and
// overflows to 2*(v-max), both escaping into the 2-bit bypass mode.  One
// stream (stream_part = 1); the encoder stages symbols and flushes LIFO.

struct IdxCdfGroup {
    std::vector<std::vector<int32_t>> rows;       // raw CDF rows
    std::vector<std::vector<CdfEntry>> sym;       // per-symbol (start, range)
    std::vector<int32_t> sizes;
    std::vector<int32_t> offsets;

    void set(const int32_t* cdfs, int n, int per, const int32_t* szs,
             const int32_t* offs) {
        rows.resize(n);
        sym.resize(n);
        sizes.assign(szs, szs + n);
        offsets.assign(offs, offs + n);
        for (int i = 0; i < n; i++) {
            const int32_t* row = cdfs + static_cast<size_t>(i) * per;
            rows[i].assign(row, row + per);
            sym[i].resize(per > 0 ? per - 1 : 0);
            for (int j = 0; j + 1 < per; j++) {
                sym[i][j].start = static_cast<uint16_t>(row[j]);
                sym[i][j].range = static_cast<uint16_t>(row[j + 1] - row[j]);
            }
        }
    }
};

struct StagedSym {
    uint16_t start;
    uint16_t range;  // range == 0 marks a raw bypass chunk
};

void istage_symbols(const IdxCdfGroup& g, const int16_t* symbols,
                    const int16_t* indexes, int n,
                    std::vector<StagedSym>& out) {
    for (int i = 0; i < n; i++) {
        const int32_t idx = indexes[i];
        if (idx < 0) continue;
        const int32_t max_value = g.sizes[idx] - 2;
        int32_t value = static_cast<int32_t>(symbols[i]) - g.offsets[idx];
        uint32_t raw = 0;
        if (value < 0) {
            raw = static_cast<uint32_t>(-2 * value - 1);
            value = max_value;
        } else if (value >= max_value) {
            raw = static_cast<uint32_t>(2 * (value - max_value));
            value = max_value;
        }
        out.push_back({g.sym[idx][value].start, g.sym[idx][value].range});
        if (value == max_value) {
            int32_t n_bypass = 0;
            while ((raw >> (n_bypass * kBypassBits)) != 0) n_bypass++;
            int32_t v = n_bypass;
            while (v >= static_cast<int32_t>(kMaxBypassVal)) {
                out.push_back({static_cast<uint16_t>(kMaxBypassVal), 0});
                v -= kMaxBypassVal;
            }
            out.push_back({static_cast<uint16_t>(v), 0});
            for (int32_t j = 0; j < n_bypass; j++) {
                out.push_back({static_cast<uint16_t>(
                                   (raw >> (j * kBypassBits)) & kMaxBypassVal),
                               0});
            }
        }
    }
}

// shared trailing zero bytes between a forward and to-be-reversed stream
int identical_trailing_bytes(const std::vector<uint8_t>& a, const std::vector<uint8_t>& b) {
    int na = static_cast<int>(a.size());
    int nb = static_cast<int>(b.size());
    int identical = 0;
    int check = std::min({na, nb, 8});
    for (int i = 0; i < check; i++) {
        if (a[na - 1 - i] != 0 || b[nb - 1 - i] != 0) break;
        identical++;
    }
    if (identical == 0 && na > 0 && nb > 0 && a[na - 1] == b[nb - 1]) {
        identical = 1;
    }
    return identical;
}

}  // namespace

// ------------------------------------------------------------------ C API

struct DcvcRansEncoder {
    CdfBank banks[2];
    int parallel = 1;
    std::vector<std::unique_ptr<EncLane>> lanes;
    // staged symbol buffers shared across lanes (kept alive until flush)
    std::vector<std::shared_ptr<std::vector<int16_t>>> held_y;
    std::vector<std::shared_ptr<std::vector<int8_t>>> held_z;

    DcvcRansEncoder() {
        lanes.reserve(kMaxParallel);
        for (int i = 0; i < kMaxParallel; i++) {
            lanes.emplace_back(new EncLane());
        }
    }
};

struct DcvcRansDecoder {
    CdfBank banks[2];
    int parallel = 1;
    std::vector<std::unique_ptr<DecLane>> lanes;
    std::vector<int8_t> decoded;
    std::vector<std::shared_ptr<std::vector<uint8_t>>> held_idx;

    DcvcRansDecoder() {
        decoded.resize(3840 * 2160 / 16 / 16 * 128 * 2);
        lanes.reserve(kMaxParallel);
        for (int i = 0; i < kMaxParallel; i++) {
            lanes.emplace_back(new DecLane());
        }
    }
};

struct DcvcIRansEncoder {
    std::vector<IdxCdfGroup> groups;
    std::vector<StagedSym> syms;
    std::vector<uint8_t> stream;
};

struct DcvcIRansDecoder {
    std::vector<IdxCdfGroup> groups;
    std::vector<uint8_t> stream;
    const uint8_t* ptr = nullptr;
    uint32_t state = 0;
};

extern "C" {

void* dcvc_rans_encoder_new() { return new DcvcRansEncoder(); }
void dcvc_rans_encoder_free(void* h) { delete static_cast<DcvcRansEncoder*>(h); }

void dcvc_rans_encoder_set_cdf(void* h, const int32_t* cdfs, int n_cdf, int per_size,
                               const int32_t* sizes, int bank) {
    static_cast<DcvcRansEncoder*>(h)->banks[bank].set(cdfs, n_cdf, per_size, sizes);
}

void dcvc_rans_encoder_set_parallel(void* h, int n) {
    static_cast<DcvcRansEncoder*>(h)->parallel = n;
}

void dcvc_rans_encoder_reset(void* h) {
    auto* e = static_cast<DcvcRansEncoder*>(h);
    for (auto& lane : e->lanes) {
        lane->worker.wait();
        lane->reset();
    }
    e->held_y.clear();
    e->held_z.clear();
}

// y symbols: int16 combined (symbol << 8 | cdf_idx); encoded backwards
void dcvc_rans_encoder_encode_y(void* h, const int16_t* symbols, int n) {
    auto* e = static_cast<DcvcRansEncoder*>(h);
    auto held = std::make_shared<std::vector<int16_t>>(symbols, symbols + n);
    e->held_y.push_back(held);
    const int np = e->parallel;
    const int size0 = n / np;
    for (int i = 0; i < np; i++) {
        const int offset = size0 * i;
        const int size = (i == np - 1) ? n - size0 * (np - 1) : size0;
        EncLane* lane = e->lanes[i].get();
        const CdfBank* bank = &e->banks[1];
        lane->worker.post([lane, bank, held, offset, size] {
            const int16_t* sym = held->data();
            const int end = offset + size - 1;
            for (int j = end; j >= offset; j--) {
                lane->ensure_headroom();
                const int16_t combined = sym[j];
                const int32_t cdf_idx = combined & 0xff;
                const int32_t s = static_cast<int8_t>(combined >> 8);
                enc_symbol(lane->state, lane->ptr, s, bank->max_value[cdf_idx],
                           bank->sym.data() + static_cast<size_t>(cdf_idx) * bank->per_size);
            }
        });
    }
}

// z symbols: int8, per-channel CDF (i % ch) + cdf_offset
void dcvc_rans_encoder_encode_z(void* h, const int8_t* symbols, int n, int cdf_offset, int ch) {
    auto* e = static_cast<DcvcRansEncoder*>(h);
    auto held = std::make_shared<std::vector<int8_t>>(symbols, symbols + n);
    e->held_z.push_back(held);
    const int np = e->parallel;
    const int size0 = n / np;
    for (int i = 0; i < np; i++) {
        const int offset = size0 * i;
        const int size = (i == np - 1) ? n - size0 * (np - 1) : size0;
        EncLane* lane = e->lanes[i].get();
        const CdfBank* bank = &e->banks[0];
        lane->worker.post([lane, bank, held, offset, size, cdf_offset, ch] {
            const int8_t* sym = held->data();
            const int end = offset + size - 1;
            for (int j = end; j >= offset; j--) {
                lane->ensure_headroom();
                const int32_t cdf_idx = (j % ch) + cdf_offset;
                enc_symbol(lane->state, lane->ptr, sym[j], bank->max_value[cdf_idx],
                           bank->sym.data() + static_cast<size_t>(cdf_idx) * bank->per_size);
            }
        });
    }
}

void dcvc_rans_encoder_flush(void* h) {
    auto* e = static_cast<DcvcRansEncoder*>(h);
    for (int i = 0; i < e->parallel; i++) {
        EncLane* lane = e->lanes[i].get();
        lane->worker.post([lane] { lane->flush(); });
    }
}

// Merge lanes into the on-the-wire format; returns total size (or required
// size if capacity is insufficient; caller retries with a bigger buffer).
int dcvc_rans_encoder_get_stream(void* h, uint8_t* out, int capacity) {
    auto* e = static_cast<DcvcRansEncoder*>(h);
    const int n = e->parallel;
    std::vector<const std::vector<uint8_t>*> res(n);
    for (int i = 0; i < n; i++) {
        e->lanes[i]->worker.wait();
        res[i] = &e->lanes[i]->out;
    }
    e->held_y.clear();
    e->held_z.clear();

    if (n == 1) {
        int sz = static_cast<int>(res[0]->size());
        if (sz <= capacity) std::memcpy(out, res[0]->data(), sz);
        return sz;
    }

    const int num_pairs = n / 2;
    const bool has_tail = (n % 2) != 0;
    std::vector<int> group_size(num_pairs), identical(num_pairs);
    for (int p = 0; p < num_pairs; p++) {
        identical[p] = identical_trailing_bytes(*res[2 * p], *res[2 * p + 1]);
        group_size[p] = static_cast<int>(res[2 * p]->size() + res[2 * p + 1]->size())
                        - identical[p];
    }
    const int tail_size = has_tail ? static_cast<int>(res[n - 1]->size()) : 0;
    const int num_offsets = num_pairs - 1 + (has_tail ? 1 : 0);
    const int header_size = num_offsets * 4;

    int total = header_size + tail_size;
    for (int p = 0; p < num_pairs; p++) total += group_size[p];
    if (total > capacity) return total;

    int cumulative = group_size[0];
    for (int k = 0; k < num_offsets; k++) {
        std::memcpy(out + k * 4, &cumulative, 4);
        if (k + 1 < num_pairs) cumulative += group_size[k + 1];
    }
    int pos = header_size;
    for (int p = 0; p < num_pairs; p++) {
        const auto& fwd = *res[2 * p];
        const auto& rev = *res[2 * p + 1];
        std::memcpy(out + pos, fwd.data(), fwd.size());
        std::reverse_copy(rev.begin(), rev.end() - identical[p],
                          out + pos + fwd.size());
        pos += group_size[p];
    }
    if (has_tail) {
        std::memcpy(out + pos, res[n - 1]->data(), tail_size);
    }
    return total;
}

void* dcvc_rans_decoder_new() { return new DcvcRansDecoder(); }
void dcvc_rans_decoder_free(void* h) { delete static_cast<DcvcRansDecoder*>(h); }

void dcvc_rans_decoder_set_cdf(void* h, const int32_t* cdfs, int n_cdf, int per_size,
                               const int32_t* sizes, int bank) {
    static_cast<DcvcRansDecoder*>(h)->banks[bank].set(cdfs, n_cdf, per_size, sizes);
}

void dcvc_rans_decoder_set_parallel(void* h, int n) {
    static_cast<DcvcRansDecoder*>(h)->parallel = n;
}

void dcvc_rans_decoder_set_stream(void* h, const uint8_t* ptr, int size) {
    auto* d = static_cast<DcvcRansDecoder*>(h);
    const int n = d->parallel;
    if (n == 1) {
        d->lanes[0]->set_stream(std::vector<uint8_t>(ptr, ptr + size));
        return;
    }
    if (n == 2) {
        d->lanes[0]->set_stream(std::vector<uint8_t>(ptr, ptr + size));
        std::vector<uint8_t> rev(size);
        std::reverse_copy(ptr, ptr + size, rev.data());
        d->lanes[1]->set_stream(std::move(rev));
        return;
    }
    const int num_pairs = n / 2;
    const bool has_tail = (n % 2) != 0;
    const int num_offsets = num_pairs - 1 + (has_tail ? 1 : 0);
    const int header_size = num_offsets * 4;
    std::vector<int> offsets(num_offsets);
    std::memcpy(offsets.data(), ptr, header_size);

    const uint8_t* payload = ptr + header_size;
    const int payload_size = size - header_size;
    for (int p = 0; p < num_pairs; p++) {
        const int start = (p == 0) ? 0 : offsets[p - 1];
        int end;
        if (p < num_offsets) {
            end = offsets[p];
        } else {
            end = has_tail ? offsets[num_offsets - 1] : payload_size;
        }
        const int gs = end - start;
        d->lanes[2 * p]->set_stream(std::vector<uint8_t>(payload + start, payload + end));
        std::vector<uint8_t> rev(gs);
        std::reverse_copy(payload + start, payload + end, rev.data());
        d->lanes[2 * p + 1]->set_stream(std::move(rev));
    }
    if (has_tail) {
        const int start = offsets[num_offsets - 1];
        d->lanes[n - 1]->set_stream(
            std::vector<uint8_t>(payload + start, payload + payload_size));
    }
}

void dcvc_rans_decoder_decode_y(void* h, const uint8_t* indexes, int n) {
    auto* d = static_cast<DcvcRansDecoder*>(h);
    if (static_cast<int>(d->decoded.size()) < n) d->decoded.resize(n * 2);
    auto held = std::make_shared<std::vector<uint8_t>>(indexes, indexes + n);
    d->held_idx.push_back(held);
    int8_t* decoded = d->decoded.data();
    const int np = d->parallel;
    const int size0 = n / np;
    for (int i = 0; i < np; i++) {
        const int offset = size0 * i;
        const int size = (i == np - 1) ? n - size0 * (np - 1) : size0;
        DecLane* lane = d->lanes[i].get();
        const CdfBank* bank = &d->banks[1];
        lane->worker.post([lane, bank, held, decoded, offset, size] {
            const uint8_t* idx = held->data();
            for (int j = 0; j < size; j++) {
                const int32_t cdf_idx = idx[j + offset];
                decoded[j + offset] = dec_symbol(
                    lane->state, lane->ptr,
                    bank->cdf.data() + static_cast<size_t>(cdf_idx) * bank->per_size,
                    bank->max_value[cdf_idx]);
            }
        });
    }
}

void dcvc_rans_decoder_decode_z(void* h, int n, int cdf_offset, int ch) {
    auto* d = static_cast<DcvcRansDecoder*>(h);
    if (static_cast<int>(d->decoded.size()) < n) d->decoded.resize(n * 2);
    int8_t* decoded = d->decoded.data();
    const int np = d->parallel;
    const int size0 = n / np;
    for (int i = 0; i < np; i++) {
        const int offset = size0 * i;
        const int size = (i == np - 1) ? n - size0 * (np - 1) : size0;
        DecLane* lane = d->lanes[i].get();
        const CdfBank* bank = &d->banks[0];
        lane->worker.post([lane, bank, decoded, offset, size, cdf_offset, ch] {
            for (int j = 0; j < size; j++) {
                const int32_t cdf_idx = ((j + offset) % ch) + cdf_offset;
                decoded[j + offset] = dec_symbol(
                    lane->state, lane->ptr,
                    bank->cdf.data() + static_cast<size_t>(cdf_idx) * bank->per_size,
                    bank->max_value[cdf_idx]);
            }
        });
    }
}

int dcvc_rans_decoder_get_decoded(void* h, int8_t* out, int n) {
    auto* d = static_cast<DcvcRansDecoder*>(h);
    for (int i = 0; i < d->parallel; i++) {
        d->lanes[i]->worker.wait();
    }
    d->held_idx.clear();
    std::memcpy(out, d->decoded.data(), n);
    return n;
}

// ------------------------------------------------- compaction helpers
// Replace the reference's on-device stream-compaction kernels: the full
// symbol/index/cond tensors cross the device->host boundary with static
// shapes, and the host compacts before entropy coding.

int dcvc_compact_i16(const int16_t* sym, const uint8_t* cond, int n, int16_t* out) {
    int k = 0;
    for (int i = 0; i < n; i++) {
        out[k] = sym[i];
        k += cond[i] != 0;
    }
    return k;
}

int dcvc_compact_u8(const uint8_t* idx, const uint8_t* cond, int n, uint8_t* out) {
    int k = 0;
    for (int i = 0; i < n; i++) {
        out[k] = idx[i];
        k += cond[i] != 0;
    }
    return k;
}

int dcvc_count_cond(const uint8_t* cond, int n) {
    int k = 0;
    for (int i = 0; i < n; i++) k += cond[i] != 0;
    return k;
}

// scatter decoded symbols back to full-size buffer; skipped positions = 0
void dcvc_scatter_i8(const int8_t* compacted, const uint8_t* cond, int n, int8_t* out) {
    int k = 0;
    for (int i = 0; i < n; i++) {
        out[i] = cond[i] ? compacted[k] : 0;
        k += cond[i] != 0;
    }
}

// ------------------------------------------------ indexed-mode C API

void* dcvc_irans_encoder_new() { return new DcvcIRansEncoder(); }

void dcvc_irans_encoder_free(void* h) {
    delete static_cast<DcvcIRansEncoder*>(h);
}

int dcvc_irans_encoder_add_cdf(void* h, const int32_t* cdfs, int n, int per,
                               const int32_t* sizes, const int32_t* offsets) {
    auto* e = static_cast<DcvcIRansEncoder*>(h);
    e->groups.emplace_back();
    e->groups.back().set(cdfs, n, per, sizes, offsets);
    return static_cast<int>(e->groups.size()) - 1;
}

void dcvc_irans_encoder_reset(void* h) {
    auto* e = static_cast<DcvcIRansEncoder*>(h);
    e->syms.clear();
    e->stream.clear();
}

void dcvc_irans_encoder_encode(void* h, const int16_t* symbols,
                               const int16_t* indexes, int n, int group) {
    auto* e = static_cast<DcvcIRansEncoder*>(h);
    istage_symbols(e->groups[group], symbols, indexes, n, e->syms);
}

void dcvc_irans_encoder_flush(void* h) {
    auto* e = static_cast<DcvcIRansEncoder*>(h);
    // worst case ~4 bytes per staged entry + final state
    std::vector<uint8_t> buf(e->syms.size() * 4 + 16);
    uint8_t* ptr = buf.data() + buf.size();
    uint32_t st = kRansL;
    for (auto it = e->syms.rbegin(); it != e->syms.rend(); ++it) {
        if (it->range != 0) {
            enc_put(st, ptr, it->start, it->range);
        } else {
            enc_put_bits(st, ptr, it->start);
        }
    }
    ptr -= 4;
    ptr[0] = static_cast<uint8_t>(st >> 0);
    ptr[1] = static_cast<uint8_t>(st >> 8);
    ptr[2] = static_cast<uint8_t>(st >> 16);
    ptr[3] = static_cast<uint8_t>(st >> 24);
    e->stream.assign(ptr, buf.data() + buf.size());
}

int dcvc_irans_encoder_get_stream(void* h, uint8_t* out, int cap) {
    auto* e = static_cast<DcvcIRansEncoder*>(h);
    const int n = static_cast<int>(e->stream.size());
    if (out != nullptr && n <= cap) {
        std::memcpy(out, e->stream.data(), n);
    }
    return n;
}

void* dcvc_irans_decoder_new() { return new DcvcIRansDecoder(); }

void dcvc_irans_decoder_free(void* h) {
    delete static_cast<DcvcIRansDecoder*>(h);
}

int dcvc_irans_decoder_add_cdf(void* h, const int32_t* cdfs, int n, int per,
                               const int32_t* sizes, const int32_t* offsets) {
    auto* d = static_cast<DcvcIRansDecoder*>(h);
    d->groups.emplace_back();
    d->groups.back().set(cdfs, n, per, sizes, offsets);
    return static_cast<int>(d->groups.size()) - 1;
}

void dcvc_irans_decoder_set_stream(void* h, const uint8_t* data, int size) {
    auto* d = static_cast<DcvcIRansDecoder*>(h);
    d->stream.assign(data, data + size);
    d->ptr = d->stream.data();
    d->state = static_cast<uint32_t>(d->ptr[0]) |
               (static_cast<uint32_t>(d->ptr[1]) << 8) |
               (static_cast<uint32_t>(d->ptr[2]) << 16) |
               (static_cast<uint32_t>(d->ptr[3]) << 24);
    d->ptr += 4;
}

void dcvc_irans_decoder_decode(void* h, const int16_t* indexes, int n,
                               int group, int16_t* out) {
    auto* d = static_cast<DcvcIRansDecoder*>(h);
    const IdxCdfGroup& g = d->groups[group];
    uint32_t st = d->state;
    const uint8_t* ptr = d->ptr;
    for (int i = 0; i < n; i++) {
        const int32_t idx = indexes[i];
        if (idx < 0) {
            out[i] = 0;
            continue;
        }
        const int32_t* cdf = g.rows[idx].data();
        const int32_t max_value = g.sizes[idx] - 2;
        const int32_t cum = static_cast<int32_t>(st & kDecMask);
        int s = 1;
        while (cdf[s] <= cum) s++;
        s--;
        st = static_cast<uint32_t>(cdf[s + 1] - cdf[s]) * (st >> kScaleBits) +
             (st & kDecMask) - static_cast<uint32_t>(cdf[s]);
        while (st < kRansL) {
            st = (st << 8) | *ptr++;
        }
        int32_t value = s;
        if (value == max_value) {
            uint32_t val = st & kMaxBypassVal;
            st >>= kBypassBits;
            if (st < kRansL) st = (st << 8) | *ptr++;
            int32_t n_bypass = static_cast<int32_t>(val);
            while (val == kMaxBypassVal) {
                val = st & kMaxBypassVal;
                st >>= kBypassBits;
                if (st < kRansL) st = (st << 8) | *ptr++;
                n_bypass += static_cast<int32_t>(val);
            }
            int32_t raw = 0;
            for (int j = 0; j < n_bypass; j++) {
                val = st & kMaxBypassVal;
                st >>= kBypassBits;
                if (st < kRansL) st = (st << 8) | *ptr++;
                raw |= static_cast<int32_t>(val) << (j * kBypassBits);
            }
            value = raw >> 1;
            if (raw & 1) {
                value = -value - 1;
            } else {
                value += max_value;
            }
        }
        out[i] = static_cast<int16_t>(value + g.offsets[idx]);
    }
    d->state = st;
    d->ptr = ptr;
}

}  // extern "C"
