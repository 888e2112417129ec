#include <atomic>
// framepack: fused letterbox-resize + BGR->I420 batch packer.
//
// The host side of the TPU pipeline must turn N camera frames (BGR, arbitrary
// resolutions) into one [N, S*3/2, S] I420 batch every tick. Through Python +
// cv2 that is two passes (resize, cvtColor) with an intermediate buffer per
// frame; this kernel fuses them — each output pixel is produced once, straight
// into the batch buffer — and parallelizes across frames with std::thread.
// This is the platform's native data-loader stage (the reference delegates the
// equivalent work to OpenCV inside its Python loops; SURVEY.md section 2.3).
//
// Layout contract (matches frp_tpu.engine.batching.letterbox + cv2 I420):
//   * uniform scale s = min(S/w, S/h), centered, zero (black) padding;
//     note black BGR encodes to Y=16, U=V=128 in studio-swing I420.
//   * I420 planes: Y [S x S], U [S/2 x S/2], V [S/2 x S/2], stored as rows of
//     width S (U and V each occupy S/4 rows).
//   * BT.601 studio swing, same integer coefficients as OpenCV.
//
// Build: g++ -O2 -shared -fPIC -o libframepack.so framepack.cpp -lpthread

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint8_t clamp_u8(int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Bilinear sample of one channel from an HxW BGR frame (stride = 3*w).
inline float sample(const uint8_t* frame, int h, int w, float y, float x, int c) {
    x = std::max(0.0f, std::min(x, static_cast<float>(w - 1)));
    y = std::max(0.0f, std::min(y, static_cast<float>(h - 1)));
    const int x0 = static_cast<int>(x);
    const int y0 = static_cast<int>(y);
    const int x1 = std::min(x0 + 1, w - 1);
    const int y1 = std::min(y0 + 1, h - 1);
    const float wx = x - x0;
    const float wy = y - y0;
    const float p00 = frame[(y0 * w + x0) * 3 + c];
    const float p01 = frame[(y0 * w + x1) * 3 + c];
    const float p10 = frame[(y1 * w + x0) * 3 + c];
    const float p11 = frame[(y1 * w + x1) * 3 + c];
    return (p00 * (1 - wx) + p01 * wx) * (1 - wy) + (p10 * (1 - wx) + p11 * wx) * wy;
}

// BT.601 studio swing (OpenCV's integer formulation).
inline void bgr_to_yuv(float b, float g, float r, uint8_t* y, uint8_t* u, uint8_t* v) {
    *y = clamp_u8(static_cast<int>(0.257f * r + 0.504f * g + 0.098f * b + 16.5f));
    if (u != nullptr) {
        *u = clamp_u8(static_cast<int>(-0.148f * r - 0.291f * g + 0.439f * b + 128.5f));
        *v = clamp_u8(static_cast<int>(0.439f * r - 0.368f * g - 0.071f * b + 128.5f));
    }
}

// rows == size packs the full letterbox square; rows < size packs only the
// ACTIVE area (the device pads the dead rows back — see
// frp_tpu.engine.batching.build_batch_i420 active_rows). Offsets are
// reported in FULL-square coordinates either way.
void pack_one(const uint8_t* frame, int h, int w, int size, int rows,
              uint8_t* out, float* scale, float* offsets) {
    const float s = std::min(static_cast<float>(size) / w,
                             static_cast<float>(rows) / h);
    const int nw = std::max(1, static_cast<int>(w * s + 0.5f));
    const int nh = std::max(1, static_cast<int>(h * s + 0.5f));
    const int ox = (size - nw) / 2;
    const int oy = (rows - nh) / 2;
    *scale = s;
    offsets[0] = static_cast<float>(ox);
    offsets[1] = static_cast<float>(oy + (size - rows) / 2);

    uint8_t* yplane = out;                       // rows x size
    uint8_t* uplane = out + rows * size;         // rows/2 x size/2, width-size rows
    uint8_t* vplane = uplane + rows * size / 4;
    // black padding: Y=16, U=V=128 (studio swing)
    std::memset(yplane, 16, static_cast<size_t>(rows) * size);
    std::memset(uplane, 128, static_cast<size_t>(rows) * size / 4);
    std::memset(vplane, 128, static_cast<size_t>(rows) * size / 4);

    const float inv = 1.0f / s;
    for (int yy = 0; yy < nh; ++yy) {
        const float sy = (yy + 0.5f) * inv - 0.5f;
        uint8_t* yrow = yplane + (oy + yy) * size + ox;
        const bool chroma_row = ((oy + yy) % 2 == 0) && (yy + 1 < nh || true);
        for (int xx = 0; xx < nw; ++xx) {
            const float sx = (xx + 0.5f) * inv - 0.5f;
            const float b = sample(frame, h, w, sy, sx, 0);
            const float g = sample(frame, h, w, sy, sx, 1);
            const float r = sample(frame, h, w, sy, sx, 2);
            uint8_t yv, uv, vv;
            const bool do_chroma = chroma_row && ((ox + xx) % 2 == 0);
            bgr_to_yuv(b, g, r, &yv, do_chroma ? &uv : nullptr,
                       do_chroma ? &vv : nullptr);
            yrow[xx] = yv;
            if (do_chroma) {
                const int cy = (oy + yy) / 2;
                const int cx = (ox + xx) / 2;
                uplane[cy * (size / 2) + cx] = uv;
                vplane[cy * (size / 2) + cx] = vv;
            }
        }
    }
}

}  // namespace

extern "C" {

// frames: n pointers to HxWx3 BGR uint8 buffers.
// out: n * (size*rows*3/2) bytes — the I420 batch [n, rows*3/2, size].
// scales: n floats; offsets: n*2 floats (ox, oy in full-square coords).
// rows == size for the full letterbox square; rows < size (multiple of 16)
// packs only the active area (device pads the rest).
void framepack_letterbox_i420_rows(const uint8_t** frames, const int* heights,
                                   const int* widths, int n, int size, int rows,
                                   uint8_t* out, float* scales, float* offsets,
                                   int n_threads) {
    const size_t frame_bytes = static_cast<size_t>(rows) * size * 3 / 2;
    if (n_threads <= 1 || n <= 1) {
        for (int i = 0; i < n; ++i) {
            pack_one(frames[i], heights[i], widths[i], size, rows,
                     out + i * frame_bytes, scales + i, offsets + 2 * i);
        }
        return;
    }
    std::vector<std::thread> workers;
    std::atomic<int> next{0};
    const int t = std::min(n_threads, n);
    for (int k = 0; k < t; ++k) {
        workers.emplace_back([&]() {
            for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
                pack_one(frames[i], heights[i], widths[i], size, rows,
                         out + i * frame_bytes, scales + i, offsets + 2 * i);
            }
        });
    }
    for (auto& w : workers) w.join();
}

// v1 ABI kept for prebuilt callers.
void framepack_letterbox_i420(const uint8_t** frames, const int* heights,
                              const int* widths, int n, int size, uint8_t* out,
                              float* scales, float* offsets, int n_threads) {
    framepack_letterbox_i420_rows(frames, heights, widths, n, size, size, out,
                                  scales, offsets, n_threads);
}

// v3: block-sparse temporal delta coding (round-3 wire compression).
//
// Surveillance batches are temporally redundant; the device keeps the
// previous reconstructed batch resident and the host ships only CHANGED
// fixed-size blocks. This kernel compares cur vs prev per `block`-byte
// block and emits (block index, block payload) pairs per frame.
//
//   cur, prev: n * frame_bytes contiguous byte batches (frame_bytes must be
//              a multiple of block).
//   cap == 0:  count-only pass — returns the max changed-block count across
//              frames without writing outputs (the host picks a capacity
//              rung from it).
//   cap  > 0:  fills idx [n, cap] (int32, -1 padded) and blocks
//              [n, cap, block]; returns the max changed count (which may
//              exceed cap — the host must treat that as "ship raw").
// Parallel across frames with std::thread.
int framepack_delta_blocks(const uint8_t* cur, const uint8_t* prev, int n,
                           long frame_bytes, int block, int cap, int32_t* idx,
                           uint8_t* blocks, int n_threads) {
    if (n <= 0) return 0;  // max_element on empty counts is UB
    const long nblocks = frame_bytes / block;
    std::vector<int> counts(n, 0);
    auto one = [&](int i) {
        const uint8_t* c = cur + i * frame_bytes;
        const uint8_t* p = prev + i * frame_bytes;
        int32_t* id = (cap > 0) ? idx + static_cast<long>(i) * cap : nullptr;
        uint8_t* bl = (cap > 0)
                          ? blocks + static_cast<long>(i) * cap * block
                          : nullptr;
        if (id != nullptr) {
            for (int j = 0; j < cap; ++j) id[j] = -1;
        }
        int found = 0;
        for (long b = 0; b < nblocks; ++b) {
            if (std::memcmp(c + b * block, p + b * block, block) != 0) {
                if (id != nullptr && found < cap) {
                    id[found] = static_cast<int32_t>(b);
                    std::memcpy(bl + static_cast<long>(found) * block,
                                c + b * block, block);
                }
                ++found;
            }
        }
        counts[i] = found;
    };
    if (n_threads <= 1 || n <= 1) {
        for (int i = 0; i < n; ++i) one(i);
    } else {
        std::vector<std::thread> workers;
        std::atomic<int> next{0};
        const int t = std::min(n_threads, n);
        for (int k = 0; k < t; ++k) {
            workers.emplace_back([&]() {
                for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) one(i);
            });
        }
        for (auto& w : workers) w.join();
    }
    return *std::max_element(counts.begin(), counts.end());
}

// v4: source-frame dirty-band detector — change hints for sources that
// can't provide them (RTSP decode, pushed frames, video files). Compares
// cur vs prev in row bands of `band` rows at memcmp speed (~5 ms for
// 8x1080p on the one-core host vs ~27 ms to fully re-letterbox), sets
// flags[i]=1 for bands that differ and copies ONLY those bands into prev
// (prev then tracks the last-seen frame). Returns the dirty-band count.
int framepack_dirty_bands(const uint8_t* cur, uint8_t* prev, int h,
                          long row_bytes, int band, uint8_t* flags) {
    if (h <= 0 || band <= 0) return 0;
    const int nbands = (h + band - 1) / band;
    int dirty = 0;
    for (int i = 0; i < nbands; ++i) {
        const int y0 = i * band;
        const int y1 = (y0 + band < h) ? y0 + band : h;
        const long off = static_cast<long>(y0) * row_bytes;
        const long len = static_cast<long>(y1 - y0) * row_bytes;
        if (std::memcmp(cur + off, prev + off, len) != 0) {
            std::memcpy(prev + off, cur + off, len);
            flags[i] = 1;
            ++dirty;
        } else {
            flags[i] = 0;
        }
    }
    return dirty;
}

int framepack_version() { return 4; }

}  // extern "C"
