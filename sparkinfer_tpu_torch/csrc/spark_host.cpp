// Host (CPU) kernels of the tiered sparse FFN, a copy of the complement and
// the reload plan of sparkinfer_tpu/native/spark_host.cpp.
//
//   - spif_sparse_complement (f32 weights) and spif_sparse_complement_f16
//     (_Float16 weights, half the host RAM): the contribution of the cold
//     neuron groups, computed on the host while the card computes the hot
//     part;
//   - spif_reload_plan: the two-pointer hot-set diff.
//
// Built by sparkinfer_tpu_torch/ops/_build.py (g++ -O3 -march=native
// -fopenmp-simd -pthread -fPIC -shared) at first use and loaded with ctypes
// (sparkinfer_tpu_torch/native.py). No other code path computes the
// complement: a failed build raises. The threads are a pool of this
// library's own (std::thread), so it needs no OpenMP runtime; the
// `omp simd` pragmas only vectorize.
//
// Work split. The reference loops over tokens in parallel, so one decode
// token runs on one thread. Here the complement runs in two parallel passes,
// neither with atomic sums:
//   1. the hidden value of every (token, group, row) whose group is cold and
//      active and whose probability passes the threshold, a task per
//      kRowsPerTask rows (each row's up and gate dot products as the
//      reference computes them), written to a buffer;
//   2. the down product, each task owning one token's slice of kDownCols
//      output columns and adding, for each of its columns, the groups in
//      ascending order and within a group the rows in ascending order.
// That is, per output element, the reference's order of additions, whatever
// the number of threads.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int32_t kDownCols = 128;  // output columns of one down-product task
constexpr int32_t kRowsPerTask = 32;  // neuron rows of one hidden-value task

// A fixed pool of worker threads; run(n, fn) calls fn(0..n-1) across them
// and the caller, and returns when every call has returned. Tasks write
// disjoint outputs, so which thread runs a task changes no result.
class Pool {
public:
    explicit Pool(int n_threads) {
        for (int i = 1; i < n_threads; i++) workers_.emplace_back([this] { loop(); });
    }
    ~Pool() {
        {
            std::lock_guard<std::mutex> lk(m_);
            stop_ = true;
        }
        cv_.notify_all();
        for (auto& t : workers_) t.join();
    }
    int size() const { return (int)workers_.size() + 1; }
    void run(int64_t n, const std::function<void(int64_t)>& fn) {
        if (workers_.empty() || n <= 1) {
            for (int64_t i = 0; i < n; i++) fn(i);
            return;
        }
        std::lock_guard<std::mutex> serial(run_m_);  // one job at a time
        {
            std::lock_guard<std::mutex> lk(m_);
            job_ = &fn;
            n_tasks_ = n;
            next_.store(0);
            active_ = (int)workers_.size();
            gen_++;
        }
        cv_.notify_all();
        work();
        std::unique_lock<std::mutex> lk(m_);
        done_.wait(lk, [this] { return active_ == 0; });
    }

private:
    void work() {
        for (int64_t i; (i = next_.fetch_add(1)) < n_tasks_;) (*job_)(i);
    }
    void loop() {
        uint64_t seen = 0;
        for (;;) {
            {
                std::unique_lock<std::mutex> lk(m_);
                cv_.wait(lk, [&] { return stop_ || gen_ != seen; });
                if (stop_) return;
                seen = gen_;
            }
            work();
            std::lock_guard<std::mutex> lk(m_);
            if (--active_ == 0) done_.notify_one();
        }
    }
    std::vector<std::thread> workers_;
    std::mutex m_, run_m_;
    std::condition_variable cv_, done_;
    const std::function<void(int64_t)>* job_ = nullptr;
    int64_t n_tasks_ = 0;
    std::atomic<int64_t> next_{0};
    int active_ = 0;
    uint64_t gen_ = 0;
    bool stop_ = false;
};

// one thread for every hardware thread
Pool& pool() {
    static Pool p(std::max((int)std::thread::hardware_concurrency(), 1));
    return p;
}

// act_kind: 0 = relu(up), 1 = fatrelu(gate)*up, 2 = relu(gate)*relu(up)
template <typename W>
void sparse_complement_impl(
    const float* x,             // (N, E)
    const W* up,                // (ng, G, E)
    const W* gate,              // (ng, G, E) or nullptr
    const W* down,              // (ng, G, E)
    const float* b_up,          // (ng, G) or nullptr
    const float* probs,         // (N, ng, G)
    const uint8_t* cold_active, // (N, ng)
    float* out,                 // (N, E), overwritten
    int32_t N, int32_t ng, int32_t G, int32_t E,
    int32_t act_kind, float fatrelu_thr, float prob_thr)
{
    const int64_t rows = (int64_t)ng * G;
    std::vector<float> hidden((size_t)N * rows, 0.f);

    const int64_t row_tasks = (rows + kRowsPerTask - 1) / kRowsPerTask;
    pool().run((int64_t)N * row_tasks, [&](int64_t task) {
        const int64_t n = task / row_tasks;
        const int64_t r0 = (task % row_tasks) * kRowsPerTask;
        const int64_t r1 = std::min(r0 + kRowsPerTask, rows);
        const float* xn = x + (size_t)n * E;
        for (int64_t gr = r0; gr < r1; gr++) {
            if (!cold_active[(size_t)n * ng + gr / G]) continue;
            if (probs[(size_t)n * rows + gr] < prob_thr) continue;
            const W* ur = up + (size_t)gr * E;
            float dot_u = 0.f;
            #pragma omp simd reduction(+:dot_u)
            for (int32_t e = 0; e < E; e++) dot_u += xn[e] * (float)ur[e];
            if (b_up) dot_u += b_up[gr];

            float h;
            if (act_kind == 0) {                    // relu(up)
                h = dot_u > 0.f ? dot_u : 0.f;
            } else {
                const W* gt = gate + (size_t)gr * E;
                float dot_g = 0.f;
                #pragma omp simd reduction(+:dot_g)
                for (int32_t e = 0; e < E; e++) dot_g += xn[e] * (float)gt[e];
                if (act_kind == 1) {                // fatrelu(gate)*up
                    h = (dot_g > fatrelu_thr ? dot_g : 0.f) * dot_u;
                } else {                            // drelu
                    h = (dot_g > 0.f ? dot_g : 0.f) * (dot_u > 0.f ? dot_u : 0.f);
                }
            }
            hidden[(size_t)n * rows + gr] = h;
        }
    });

    const int32_t n_slices = (E + kDownCols - 1) / kDownCols;
    pool().run((int64_t)N * n_slices, [&](int64_t task) {
        const int64_t n = task / n_slices;
        const int32_t e0 = (int32_t)(task % n_slices) * kDownCols;
        const int32_t e1 = std::min(e0 + kDownCols, E);
        float* on = out + (size_t)n * E;
        std::memset(on + e0, 0, sizeof(float) * (e1 - e0));
        for (int32_t g = 0; g < ng; g++) {
            if (!cold_active[(size_t)n * ng + g]) continue;
            for (int32_t r = 0; r < G; r++) {
                const float h = hidden[(size_t)n * rows + (int64_t)g * G + r];
                if (h == 0.f) continue;
                const W* dr = down + ((size_t)g * G + r) * E;
                #pragma omp simd
                for (int32_t e = e0; e < e1; e++) on[e] += h * (float)dr[e];
            }
        }
    });
}

}  // namespace

extern "C" {

void spif_sparse_complement(
    const float* x, const float* up, const float* gate, const float* down,
    const float* b_up, const float* probs, const uint8_t* cold_active,
    float* out, int32_t N, int32_t ng, int32_t G, int32_t E,
    int32_t act_kind, float fatrelu_thr, float prob_thr)
{
    sparse_complement_impl<float>(x, up, gate, down, b_up, probs, cold_active,
                                  out, N, ng, G, E, act_kind, fatrelu_thr,
                                  prob_thr);
}

// _Float16 weights: the cold store at half the host RAM, converted to f32
// inside the dot loops. Present only where the compiler has _Float16
// (spif_has_f16); the caller checks before it calls.
int32_t spif_sparse_complement_f16(
    const float* x, const uint16_t* up, const uint16_t* gate,
    const uint16_t* down, const float* b_up, const float* probs,
    const uint8_t* cold_active, float* out,
    int32_t N, int32_t ng, int32_t G, int32_t E,
    int32_t act_kind, float fatrelu_thr, float prob_thr)
{
#if defined(__FLT16_MAX__)
    sparse_complement_impl<_Float16>(
        x, (const _Float16*)up, (const _Float16*)gate, (const _Float16*)down,
        b_up, probs, cold_active, out, N, ng, G, E, act_kind, fatrelu_thr,
        prob_thr);
    return 0;
#else
    (void)x; (void)up; (void)gate; (void)down; (void)b_up; (void)probs;
    (void)cold_active; (void)out; (void)N; (void)ng; (void)G; (void)E;
    (void)act_kind; (void)fatrelu_thr; (void)prob_thr;
    return -1;
#endif
}

int32_t spif_has_f16(void) {
#if defined(__FLT16_MAX__)
    return 1;
#else
    return 0;
#endif
}

// Two-pointer reload plan (ref: sparkinfer_reload_plan,
// src/llama-sparkinfer.cpp:45-91): walk the desired groups in order; each
// one not resident takes the first slot whose group is not desired and not
// yet taken; at most `window` pairs. Returns the number of pairs written.
int32_t spif_reload_plan(
    const int32_t* current_hot, int32_t H,
    const int32_t* desired_hot, int32_t Hd,
    int32_t window,
    int32_t* out_slots, int32_t* out_groups)
{
    int32_t n_pairs = 0;
    for (int32_t d = 0; d < Hd && n_pairs < window; d++) {
        int32_t g = desired_hot[d];
        bool have = false;
        for (int32_t s = 0; s < H; s++) {
            if (current_hot[s] == g) { have = true; break; }
        }
        if (have) continue;
        for (int32_t s = 0; s < H; s++) {
            int32_t cur = current_hot[s];
            bool keep = false;
            for (int32_t dd = 0; dd < Hd; dd++) {
                if (desired_hot[dd] == cur) { keep = true; break; }
            }
            if (keep) continue;
            bool used = false;
            for (int32_t p = 0; p < n_pairs; p++) {
                if (out_slots[p] == s) { used = true; break; }
            }
            if (used) continue;
            out_slots[n_pairs] = s;
            out_groups[n_pairs] = g;
            n_pairs++;
            break;
        }
    }
    return n_pairs;
}

int32_t spif_num_threads(void) {
    return pool().size();
}

}  // extern "C"
