// Double-ended sample streamer: a producer thread reads fixed-size blocks
// from a capture file into a ring of buffers; the consumer (Python) pops
// blocks with a timeout. Equivalent of CUDARecv's SampleBlock
// (sampleblock.cu:307-515): N-deep ring, producer/consumer semaphores,
// fail-fast 1.5 s timeout, clean EOF drain. Host buffers only — the device
// copy is the Python side's job.
//
// C ABI for ctypes; built with the host C++ compiler at first use by
// runtime/nativelib.py (a copy of the JAX package's runtime/native source).

#include <arpa/inet.h>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <netdb.h>
#include <netinet/in.h>
#include <pthread.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct Ring {
    FILE* fo = nullptr;
    long block_bytes = 0;
    int n_buffers = 0;
    char* storage = nullptr;     // n_buffers * block_bytes
    long* fill = nullptr;        // bytes valid per slot
    int head = 0;                // next slot to consume
    int tail = 0;                // next slot to fill
    int count = 0;               // filled slots
    bool eof = false;
    bool stop = false;
    double timeout_s = 1.5;      // reference watchdog (sampleblock.cu:432)
    pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
    pthread_cond_t can_fill = PTHREAD_COND_INITIALIZER;
    pthread_cond_t can_pop = PTHREAD_COND_INITIALIZER;
    pthread_t reader;
};

void deadline(timespec* ts, double dt) {
    clock_gettime(CLOCK_REALTIME, ts);
    long ns = ts->tv_nsec + (long)(dt * 1e9);
    ts->tv_sec += ns / 1000000000L;
    ts->tv_nsec = ns % 1000000000L;
}

void* reader_main(void* arg) {
    Ring* r = static_cast<Ring*>(arg);
    for (;;) {
        pthread_mutex_lock(&r->mu);
        while (r->count == r->n_buffers && !r->stop)
            pthread_cond_wait(&r->can_fill, &r->mu);
        if (r->stop) { pthread_mutex_unlock(&r->mu); return nullptr; }
        int slot = r->tail;
        pthread_mutex_unlock(&r->mu);

        long got = (long)fread(r->storage + (size_t)slot * r->block_bytes, 1,
                               r->block_bytes, r->fo);

        pthread_mutex_lock(&r->mu);
        r->fill[slot] = got;
        r->tail = (r->tail + 1) % r->n_buffers;
        r->count++;
        if (got < r->block_bytes) r->eof = true;
        pthread_cond_signal(&r->can_pop);
        bool done = r->eof || r->stop;
        pthread_mutex_unlock(&r->mu);
        if (done) return nullptr;
    }
}

Ring* ring_start(FILE* fo, long block_bytes, int n_buffers,
                 double timeout_s) {
    Ring* r = new Ring();
    r->fo = fo;
    r->block_bytes = block_bytes;
    r->n_buffers = n_buffers;
    r->timeout_s = timeout_s > 0 ? timeout_s : 1.5;
    r->storage = (char*)malloc((size_t)block_bytes * n_buffers);
    r->fill = (long*)calloc(n_buffers, sizeof(long));
    if (!r->storage || !r->fill ||
        pthread_create(&r->reader, nullptr, reader_main, r) != 0) {
        fclose(fo);
        free(r->storage);
        free(r->fill);
        delete r;
        return nullptr;
    }
    return r;
}

}  // namespace

extern "C" {

void* sr_open(const char* path, long block_bytes, int n_buffers,
              long start_byte, double timeout_s) {
    FILE* fo = fopen(path, "rb");
    if (!fo) return nullptr;
    if (start_byte > 0 && fseek(fo, start_byte, SEEK_SET) != 0) {
        fclose(fo);
        return nullptr;
    }
    return ring_start(fo, block_bytes, n_buffers, timeout_s);
}

// TCP sample source (reference sampleblock.cu:134-156 — the upstream
// socket mode never worked; this one does). Connects, optionally skips
// start_byte bytes of the stream, then streams fixed-size blocks through
// the same ring. fread on the socket stream blocks until a full block
// arrives (fixed-rate live streaming semantics); a short read means the
// peer closed.
void* sr_open_tcp(const char* host, int port, long block_bytes,
                  int n_buffers, long start_byte, double timeout_s) {
    addrinfo hints = {};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    char portstr[16];
    snprintf(portstr, sizeof portstr, "%d", port);
    addrinfo* res = nullptr;
    if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res)
        return nullptr;
    // enforce timeout_s on the socket itself (set before connect so the
    // connect is bounded too): without it fread blocks forever on a
    // stalled peer and sr_close deadlocks in pthread_join. A recv timeout
    // surfaces as a short fread -> ring EOF (fail-fast, reference
    // watchdog semantics, sampleblock.cu:432-447).
    timeval tv;
    double t = timeout_s > 0 ? timeout_s : 1.5;
    tv.tv_sec = (long)t;
    tv.tv_usec = (long)((t - (double)tv.tv_sec) * 1e6);
    int fd = -1;
    for (addrinfo* ai = res; ai; ai = ai->ai_next) {
        fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
        if (fd < 0) continue;
        setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
        setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
        if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
        close(fd);
        fd = -1;
    }
    freeaddrinfo(res);
    if (fd < 0) return nullptr;
    FILE* fo = fdopen(fd, "rb");
    if (!fo) {
        close(fd);
        return nullptr;
    }
    // drain the skip prefix (lseek is meaningless on a socket)
    char buf[65536];
    long left = start_byte;
    while (left > 0) {
        size_t want = left < (long)sizeof buf ? (size_t)left : sizeof buf;
        size_t got = fread(buf, 1, want, fo);
        if (got == 0) {
            fclose(fo);
            return nullptr;
        }
        left -= (long)got;
    }
    return ring_start(fo, block_bytes, n_buffers, timeout_s);
}

// Pop the next block into dst. Returns bytes copied (may be < block_bytes at
// EOF), 0 on clean EOF, -1 on timeout (watchdog).
long sr_next(void* h, void* dst) {
    Ring* r = static_cast<Ring*>(h);
    timespec ts;
    deadline(&ts, r->timeout_s);
    pthread_mutex_lock(&r->mu);
    while (r->count == 0) {
        if (r->eof || r->stop) { pthread_mutex_unlock(&r->mu); return 0; }
        if (pthread_cond_timedwait(&r->can_pop, &r->mu, &ts) != 0) {
            pthread_mutex_unlock(&r->mu);
            return -1;  // fail-fast: flow should crash (README.md:108)
        }
    }
    int slot = r->head;
    long got = r->fill[slot];
    memcpy(dst, r->storage + (size_t)slot * r->block_bytes, (size_t)got);
    r->head = (r->head + 1) % r->n_buffers;
    r->count--;
    pthread_cond_signal(&r->can_fill);
    pthread_mutex_unlock(&r->mu);
    return got;
}

int sr_depth(void* h) {
    Ring* r = static_cast<Ring*>(h);
    pthread_mutex_lock(&r->mu);
    int c = r->count;
    pthread_mutex_unlock(&r->mu);
    return c;
}

void sr_close(void* h) {
    Ring* r = static_cast<Ring*>(h);
    pthread_mutex_lock(&r->mu);
    r->stop = true;
    pthread_cond_broadcast(&r->can_fill);
    pthread_cond_broadcast(&r->can_pop);
    pthread_mutex_unlock(&r->mu);
    pthread_join(r->reader, nullptr);
    fclose(r->fo);
    free(r->storage);
    free(r->fill);
    delete r;
}

}  // extern "C"
