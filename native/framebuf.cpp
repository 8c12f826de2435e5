// Native host-side runtime: frame ring buffer + Y4M decoder.
//
// The reference's data path is a synchronous cv::VideoCapture >> frame in
// the render loop (src/main_utils.cpp:397-417).  For an engine that can
// consume hundreds of frames per second, decode must be decoupled from the
// device feed: this library provides
//
//  - FrameRing: a fixed-capacity, contiguous-storage, mutex+condvar
//    producer/consumer ring for raw frames.  A decoder thread pushes,
//    the device feeder pops; preallocated storage means no allocator or GC
//    traffic per frame.
//  - y4m_*: a dependency-free YUV4MPEG2 (C444/C420) file reader with C++
//    YUV->BGR conversion, so file input works even without OpenCV.
//
// Exposed as a plain C ABI for Python ctypes (io/native.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <mutex>
#include <string>

extern "C" {

// ---------------------------------------------------------------------------
// FrameRing
// ---------------------------------------------------------------------------

struct FrameRing {
    uint8_t* storage;
    int capacity;
    long frame_bytes;
    int head;      // next slot to pop
    int count;     // frames currently stored
    bool closed;
    std::mutex m;
    std::condition_variable cv_push;
    std::condition_variable cv_pop;
};

FrameRing* ring_create(int capacity, long frame_bytes) {
    if (capacity <= 0 || frame_bytes <= 0) return nullptr;
    auto* r = new FrameRing();
    r->storage = static_cast<uint8_t*>(std::malloc(
        static_cast<size_t>(capacity) * frame_bytes));
    if (!r->storage) { delete r; return nullptr; }
    r->capacity = capacity;
    r->frame_bytes = frame_bytes;
    r->head = 0;
    r->count = 0;
    r->closed = false;
    return r;
}

void ring_destroy(FrameRing* r) {
    if (!r) return;
    std::free(r->storage);
    delete r;
}

// Blocking push; returns 1 on success, 0 if the ring was closed.
int ring_push(FrameRing* r, const uint8_t* data, int timeout_ms) {
    std::unique_lock<std::mutex> lk(r->m);
    auto pred = [r] { return r->count < r->capacity || r->closed; };
    if (timeout_ms < 0) {
        r->cv_push.wait(lk, pred);
    } else if (!r->cv_push.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred)) {
        return 0;
    }
    if (r->closed) return 0;
    int slot = (r->head + r->count) % r->capacity;
    std::memcpy(r->storage + static_cast<size_t>(slot) * r->frame_bytes,
                data, r->frame_bytes);
    r->count++;
    r->cv_pop.notify_one();
    return 1;
}

// Blocking pop; returns 1 on success, 0 on EOF (closed and drained) or timeout.
int ring_pop(FrameRing* r, uint8_t* out, int timeout_ms) {
    std::unique_lock<std::mutex> lk(r->m);
    auto pred = [r] { return r->count > 0 || r->closed; };
    if (timeout_ms < 0) {
        r->cv_pop.wait(lk, pred);
    } else if (!r->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred)) {
        return 0;
    }
    if (r->count == 0) return 0;   // closed + drained = EOF
    std::memcpy(out, r->storage + static_cast<size_t>(r->head) * r->frame_bytes,
                r->frame_bytes);
    r->head = (r->head + 1) % r->capacity;
    r->count--;
    r->cv_push.notify_one();
    return 1;
}

int ring_size(FrameRing* r) {
    std::lock_guard<std::mutex> lk(r->m);
    return r->count;
}

void ring_close(FrameRing* r) {
    std::lock_guard<std::mutex> lk(r->m);
    r->closed = true;
    r->cv_push.notify_all();
    r->cv_pop.notify_all();
}

// ---------------------------------------------------------------------------
// Y4M reader
// ---------------------------------------------------------------------------

struct Y4MReader {
    FILE* f;
    int width;
    int height;
    int fps_num;
    int fps_den;
    int c420;             // 1 if 4:2:0 subsampled, else 4:4:4
    uint8_t* ybuf;
    uint8_t* ubuf;
    uint8_t* vbuf;
};

Y4MReader* y4m_open(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    char line[512];
    if (!std::fgets(line, sizeof line, f)) { std::fclose(f); return nullptr; }
    if (std::strncmp(line, "YUV4MPEG2", 9) != 0) { std::fclose(f); return nullptr; }

    auto* r = new Y4MReader();
    r->f = f;
    r->width = r->height = 0;
    r->fps_num = 30; r->fps_den = 1;
    r->c420 = 0;
    char* tok = std::strtok(line + 9, " \n");
    while (tok) {
        if (tok[0] == 'W') r->width = std::atoi(tok + 1);
        else if (tok[0] == 'H') r->height = std::atoi(tok + 1);
        else if (tok[0] == 'F') std::sscanf(tok + 1, "%d:%d", &r->fps_num, &r->fps_den);
        else if (tok[0] == 'C') r->c420 = (std::strncmp(tok + 1, "420", 3) == 0);
        tok = std::strtok(nullptr, " \n");
    }
    if (r->width <= 0 || r->height <= 0) { std::fclose(f); delete r; return nullptr; }
    // C420 with odd dimensions is rejected: every consumer (y4m_read_bgr's
    // ci indexing, y4m_read_yuv's ysize/4 chroma size, and the device-side
    // yuv_flat_to_bgr reshape) assumes chroma planes of exactly
    // (H/2)*(W/2) == ysize/4 bytes, which only holds for even H and W.
    if (r->c420 && ((r->width & 1) || (r->height & 1))) {
        std::fclose(f); delete r; return nullptr;
    }
    size_t ysize = static_cast<size_t>(r->width) * r->height;
    size_t csize = r->c420 ? ysize / 4 : ysize;
    r->ybuf = static_cast<uint8_t*>(std::malloc(ysize));
    r->ubuf = static_cast<uint8_t*>(std::malloc(csize));
    r->vbuf = static_cast<uint8_t*>(std::malloc(csize));
    return r;
}

int y4m_width(Y4MReader* r) { return r->width; }
int y4m_height(Y4MReader* r) { return r->height; }
double y4m_fps(Y4MReader* r) {
    return r->fps_den > 0 ? static_cast<double>(r->fps_num) / r->fps_den : 30.0;
}

static inline uint8_t clamp_u8(float x) {
    return x < 0.f ? 0 : (x > 255.f ? 255 : static_cast<uint8_t>(x + 0.5f));
}

// Reads one frame into out (H*W*3 BGR). Returns 1 ok, 0 EOF/error.
int y4m_read_bgr(Y4MReader* r, uint8_t* out) {
    char hdr[256];
    if (!std::fgets(hdr, sizeof hdr, r->f)) return 0;
    if (std::strncmp(hdr, "FRAME", 5) != 0) return 0;
    size_t ysize = static_cast<size_t>(r->width) * r->height;
    size_t csize = r->c420 ? ysize / 4 : ysize;
    if (std::fread(r->ybuf, 1, ysize, r->f) != ysize) return 0;
    if (std::fread(r->ubuf, 1, csize, r->f) != csize) return 0;
    if (std::fread(r->vbuf, 1, csize, r->f) != csize) return 0;

    int cw = r->c420 ? r->width / 2 : r->width;
    for (int y = 0; y < r->height; ++y) {
        for (int x = 0; x < r->width; ++x) {
            float Y = r->ybuf[static_cast<size_t>(y) * r->width + x];
            size_t ci = r->c420
                ? static_cast<size_t>(y / 2) * cw + (x / 2)
                : static_cast<size_t>(y) * r->width + x;
            float U = static_cast<float>(r->ubuf[ci]) - 128.f;
            float V = static_cast<float>(r->vbuf[ci]) - 128.f;
            // BT.601 inverse of the writer's forward transform
            float R = Y + 1.403f * V;
            float G = Y - 0.344f * U - 0.714f * V;
            float B = Y + 1.773f * U;
            size_t o = (static_cast<size_t>(y) * r->width + x) * 3;
            out[o + 0] = clamp_u8(B);
            out[o + 1] = clamp_u8(G);
            out[o + 2] = clamp_u8(R);
        }
    }
    return 1;
}

int y4m_is_c420(Y4MReader* r) { return r->c420; }

// Reads one frame's RAW planes packed Y|U|V into out (ysize + 2*csize
// bytes) with NO colorspace conversion — pure fread.  The per-pixel float
// YUV->BGR loop in y4m_read_bgr is ~10x the cost of the read itself at
// 360p; the engine converts on device instead
// (ops/image.py yuv_planes_to_bgr / yuv_flat_to_bgr), which also halves
// H2D bytes for C420.
int y4m_read_yuv(Y4MReader* r, uint8_t* out) {
    char hdr[256];
    if (!std::fgets(hdr, sizeof hdr, r->f)) return 0;
    if (std::strncmp(hdr, "FRAME", 5) != 0) return 0;
    size_t ysize = static_cast<size_t>(r->width) * r->height;
    size_t csize = r->c420 ? ysize / 4 : ysize;
    if (std::fread(out, 1, ysize, r->f) != ysize) return 0;
    if (std::fread(out + ysize, 1, csize, r->f) != csize) return 0;
    if (std::fread(out + ysize + csize, 1, csize, r->f) != csize) return 0;
    return 1;
}

// Reads up to k frames of packed Y|U|V planes laid out contiguously in out
// (k * (ysize + 2*csize) bytes).  Returns the number of frames read.  One
// C call per chunk amortizes the per-frame FFI/Python cost that capped the
// end-to-end file-streaming rate (the single-core host spent more time in
// per-frame ring pops and numpy copies than in fread itself).
int y4m_read_yuv_block(Y4MReader* r, uint8_t* out, int k) {
    size_t ysize = static_cast<size_t>(r->width) * r->height;
    size_t csize = r->c420 ? ysize / 4 : ysize;
    size_t fbytes = ysize + 2 * csize;
    int n = 0;
    for (; n < k; ++n) {
        if (!y4m_read_yuv(r, out + static_cast<size_t>(n) * fbytes)) break;
    }
    return n;
}

void y4m_close(Y4MReader* r) {
    if (!r) return;
    std::fclose(r->f);
    std::free(r->ybuf);
    std::free(r->ubuf);
    std::free(r->vbuf);
    delete r;
}

}  // extern "C"
