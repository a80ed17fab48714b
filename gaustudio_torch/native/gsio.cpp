// gsio: native readers of COLMAP binary model files for gaustudio_torch
// (the port's copy of native/gsio.cpp, without its unbound PLY extractor).
//
// points3D.bin and images.bin are record-streamed structures that a Python
// struct loop parses slowly; this library parses them in one pass over the
// file and returns flat arrays through a C ABI bound with ctypes
// (gaustudio_torch/utils/native.py).
//
// Formats (see colmap/src/base/reconstruction.cc):
//   points3D.bin: u64 count; per point: u64 id, 3xf64 xyz, 3xu8 rgb,
//                 f64 error, u64 track_len, track_len x (i32, i32)
//   images.bin:   u64 count; per image: i32 id, 4xf64 qvec, 3xf64 tvec,
//                 i32 camera_id, name\0, u64 n2d, n2d x (f64, f64, i64)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Buffer {
    std::vector<uint8_t> data;
    size_t pos = 0;

    bool load(const char* path) {
        FILE* f = std::fopen(path, "rb");
        if (!f) return false;
        std::fseek(f, 0, SEEK_END);
        long size = std::ftell(f);
        std::fseek(f, 0, SEEK_SET);
        data.resize(static_cast<size_t>(size));
        size_t got = std::fread(data.data(), 1, data.size(), f);
        std::fclose(f);
        return got == data.size();
    }

    template <typename T>
    bool read(T* out, size_t n = 1) {
        size_t bytes = sizeof(T) * n;
        if (pos + bytes > data.size()) return false;
        std::memcpy(out, data.data() + pos, bytes);
        pos += bytes;
        return true;
    }

    bool skip(size_t bytes) {
        if (pos + bytes > data.size()) return false;
        pos += bytes;
        return true;
    }
};

}  // namespace

extern "C" {

// Returns the number of points (or -1 on error). Caller then allocates
// xyz[3n] f64, rgb[3n] u8, err[n] f64 and calls gsio_read_points3d_fill.
long long gsio_points3d_count(const char* path) {
    Buffer buf;
    if (!buf.load(path)) return -1;
    uint64_t n = 0;
    if (!buf.read(&n)) return -1;
    return static_cast<long long>(n);
}

int gsio_read_points3d(const char* path, double* xyz, uint8_t* rgb,
                       double* err, long long capacity) {
    Buffer buf;
    if (!buf.load(path)) return -1;
    uint64_t n = 0;
    if (!buf.read(&n)) return -2;
    if (static_cast<long long>(n) > capacity) return -3;
    for (uint64_t i = 0; i < n; ++i) {
        uint64_t id;
        if (!buf.read(&id)) return -4;
        if (!buf.read(xyz + 3 * i, 3)) return -4;
        if (!buf.read(rgb + 3 * i, 3)) return -4;
        if (!buf.read(err + i)) return -4;
        uint64_t track_len;
        if (!buf.read(&track_len)) return -4;
        if (!buf.skip(track_len * 8)) return -4;
    }
    return static_cast<int>(n);
}

// Two-pass image reader. Pass 1: counts. Pass 2: fills flat arrays:
//   ids[n] i32, qvec[4n] f64, tvec[3n] f64, camera_ids[n] i32,
//   names: concatenated, '\n'-separated into names_buf (names_cap bytes),
//   n2d[n] i64, xys[2*total2d] f64, p3d_ids[total2d] i64.
int gsio_images_counts(const char* path, long long* n_images,
                       long long* total_2d, long long* names_bytes) {
    Buffer buf;
    if (!buf.load(path)) return -1;
    uint64_t n = 0;
    if (!buf.read(&n)) return -2;
    long long t2d = 0, nb = 0;
    for (uint64_t i = 0; i < n; ++i) {
        if (!buf.skip(4 + 32 + 24 + 4)) return -4;
        // name until NUL
        while (buf.pos < buf.data.size() && buf.data[buf.pos] != 0) {
            ++buf.pos;
            ++nb;
        }
        if (!buf.skip(1)) return -4;
        ++nb;  // separator
        uint64_t n2d;
        if (!buf.read(&n2d)) return -4;
        t2d += static_cast<long long>(n2d);
        if (!buf.skip(n2d * 24)) return -4;
    }
    *n_images = static_cast<long long>(n);
    *total_2d = t2d;
    *names_bytes = nb;
    return 0;
}

int gsio_read_images(const char* path, int32_t* ids, double* qvec,
                     double* tvec, int32_t* camera_ids, char* names_buf,
                     long long names_cap, int64_t* n2d_out, double* xys,
                     int64_t* p3d_ids, long long img_cap, long long pt_cap) {
    Buffer buf;
    if (!buf.load(path)) return -1;
    uint64_t n = 0;
    if (!buf.read(&n)) return -2;
    if (static_cast<long long>(n) > img_cap) return -3;
    long long nb = 0, pt = 0;
    for (uint64_t i = 0; i < n; ++i) {
        if (!buf.read(ids + i)) return -4;
        if (!buf.read(qvec + 4 * i, 4)) return -4;
        if (!buf.read(tvec + 3 * i, 3)) return -4;
        if (!buf.read(camera_ids + i)) return -4;
        while (buf.pos < buf.data.size() && buf.data[buf.pos] != 0) {
            if (nb >= names_cap) return -5;
            names_buf[nb++] = static_cast<char>(buf.data[buf.pos++]);
        }
        if (!buf.skip(1)) return -4;
        if (nb >= names_cap) return -5;
        names_buf[nb++] = '\n';
        uint64_t n2d;
        if (!buf.read(&n2d)) return -4;
        n2d_out[i] = static_cast<int64_t>(n2d);
        if (pt + static_cast<long long>(n2d) > pt_cap) return -6;
        for (uint64_t j = 0; j < n2d; ++j) {
            if (!buf.read(xys + 2 * (pt + j), 2)) return -4;
            int64_t pid;
            if (!buf.read(&pid)) return -4;
            p3d_ids[pt + j] = pid;
        }
        pt += static_cast<long long>(n2d);
    }
    return static_cast<int>(n);
}

}  // extern "C"
