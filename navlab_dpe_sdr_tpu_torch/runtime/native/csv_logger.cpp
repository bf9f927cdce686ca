// Asynchronous row logger: the caller enqueues fixed-width double rows; a
// writer thread drains them to CSV or raw binary so the hot loop never
// blocks on disk. Equivalent of CUDARecv's DataLogger (datalogger.cu:45-278):
// N-deep ring, low-priority writer thread, timeout semantics on a full
// ring, CSV/binary switch (datalogger.cu:45-50); complex ports are handled
// by the Python adapter interleaving re/im (datalogger.cu:241-243).
//
// C ABI for ctypes; built with the host C++ compiler at first use by
// runtime/nativelib.py (a copy of the JAX package's runtime/native source).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <pthread.h>

namespace {

struct Logger {
    FILE* fo = nullptr;
    int n_cols = 0;
    int binary = 0;              // 0 = CSV text, 1 = raw little-endian f64
    int depth = 0;
    double* ring = nullptr;      // depth * n_cols
    int head = 0, tail = 0, count = 0;
    bool stop = false;
    double timeout_s = 1.5;
    pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
    pthread_cond_t can_put = PTHREAD_COND_INITIALIZER;
    pthread_cond_t can_get = PTHREAD_COND_INITIALIZER;
    pthread_t writer;
};

void deadline(timespec* ts, double dt) {
    clock_gettime(CLOCK_REALTIME, ts);
    long ns = ts->tv_nsec + (long)(dt * 1e9);
    ts->tv_sec += ns / 1000000000L;
    ts->tv_nsec = ns % 1000000000L;
}

void* writer_main(void* arg) {
    Logger* lg = static_cast<Logger*>(arg);
    for (;;) {
        pthread_mutex_lock(&lg->mu);
        while (lg->count == 0 && !lg->stop)
            pthread_cond_wait(&lg->can_get, &lg->mu);
        if (lg->count == 0 && lg->stop) {
            pthread_mutex_unlock(&lg->mu);
            return nullptr;
        }
        int slot = lg->head;
        pthread_mutex_unlock(&lg->mu);

        const double* row = lg->ring + (size_t)slot * lg->n_cols;
        if (lg->binary) {
            fwrite(row, sizeof(double), lg->n_cols, lg->fo);
        } else {
            for (int i = 0; i < lg->n_cols; i++)
                fprintf(lg->fo, i + 1 < lg->n_cols ? "%.12g," : "%.12g\n",
                        row[i]);
        }

        pthread_mutex_lock(&lg->mu);
        lg->head = (lg->head + 1) % lg->depth;
        lg->count--;
        pthread_cond_signal(&lg->can_put);
        pthread_mutex_unlock(&lg->mu);
    }
}

}  // namespace

extern "C" {

void* lg_open2(const char* path, int n_cols, int depth, double timeout_s,
               int binary) {
    FILE* fo = fopen(path, binary ? "wb" : "w");
    if (!fo) return nullptr;
    Logger* lg = new Logger();
    lg->fo = fo;
    lg->n_cols = n_cols;
    lg->binary = binary;
    lg->depth = depth;
    lg->timeout_s = timeout_s > 0 ? timeout_s : 1.5;
    lg->ring = (double*)malloc(sizeof(double) * (size_t)n_cols * depth);
    if (!lg->ring || pthread_create(&lg->writer, nullptr, writer_main, lg)) {
        fclose(fo);
        free(lg->ring);
        delete lg;
        return nullptr;
    }
    return lg;
}

void* lg_open(const char* path, int n_cols, int depth, double timeout_s) {
    return lg_open2(path, n_cols, depth, timeout_s, 0);
}

// Enqueue one row. Returns 0 on success, -1 on timeout (ring full too long).
int lg_write(void* h, const double* row) {
    Logger* lg = static_cast<Logger*>(h);
    timespec ts;
    deadline(&ts, lg->timeout_s);
    pthread_mutex_lock(&lg->mu);
    while (lg->count == lg->depth) {
        if (pthread_cond_timedwait(&lg->can_put, &lg->mu, &ts) != 0) {
            pthread_mutex_unlock(&lg->mu);
            return -1;
        }
    }
    memcpy(lg->ring + (size_t)lg->tail * lg->n_cols, row,
           sizeof(double) * lg->n_cols);
    lg->tail = (lg->tail + 1) % lg->depth;
    lg->count++;
    pthread_cond_signal(&lg->can_get);
    pthread_mutex_unlock(&lg->mu);
    return 0;
}

void lg_close(void* h) {
    Logger* lg = static_cast<Logger*>(h);
    pthread_mutex_lock(&lg->mu);
    lg->stop = true;
    pthread_cond_broadcast(&lg->can_get);
    pthread_mutex_unlock(&lg->mu);
    pthread_join(lg->writer, nullptr);
    fclose(lg->fo);
    free(lg->ring);
    delete lg;
}

}  // extern "C"
