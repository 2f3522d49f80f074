// Host data plane of the PyTorch port: the input pipeline's hot loop.
//
// The port's own copy of coalign_tpu/native/data_plane.cpp (the role of the
// reference's pypcd parsing and dataloader workers; ref
// opencood/utils/pcd_utils.py, opencood/tools/train.py:42): parsing PCD
// files (one file, or a frame's files in parallel threads), range-masking,
// subsampling and padding points into the fixed-shape batch buffers,
// projecting points, and a pillar table. A small C ABI library, loaded with
// ctypes; voxelization proper runs on the device (ops/pillars.py).
//
// Build: coalign_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC) into
// coalign_tpu_torch/_build/ at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>

#include <atomic>
#include <thread>
#include <vector>

extern "C" {

// Parse a PCD v0.7 file with fields x y z intensity (binary or ascii).
// Writes at most max_points rows into out (max_points x 4 float32).
// Returns number of points written, or -1 on error.
int64_t parse_pcd(const char* path, float* out, int64_t max_points) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;

    char line[512];
    int64_t npts = 0;
    int fields = 4;
    bool binary = false;
    // header
    while (fgets(line, sizeof(line), f)) {
        if (strncmp(line, "FIELDS", 6) == 0) {
            fields = 0;
            for (char* p = line + 6; *p; ++p)
                if (*p == ' ' && *(p + 1) != '\n' && *(p + 1) != 0) fields++;
        } else if (strncmp(line, "POINTS", 6) == 0) {
            npts = strtoll(line + 7, nullptr, 10);
        } else if (strncmp(line, "DATA", 4) == 0) {
            binary = strncmp(line + 5, "binary", 6) == 0;
            break;
        }
    }
    if (npts <= 0 || fields < 3) { fclose(f); return -1; }

    int64_t written = 0;
    if (binary) {
        float* row = new float[fields];
        for (int64_t i = 0; i < npts && written < max_points; ++i) {
            if (fread(row, sizeof(float), fields, f)
                    != static_cast<size_t>(fields)) break;
            bool ok = true;
            for (int c = 0; c < 3; ++c) if (std::isnan(row[c])) ok = false;
            if (!ok) continue;
            out[written * 4 + 0] = row[0];
            out[written * 4 + 1] = row[1];
            out[written * 4 + 2] = row[2];
            out[written * 4 + 3] = fields > 3 ? row[3] : 0.0f;
            written++;
        }
        delete[] row;
    } else {
        double v[8];
        while (written < max_points && fgets(line, sizeof(line), f)) {
            int got = sscanf(line, "%lf %lf %lf %lf %lf %lf %lf %lf",
                             &v[0], &v[1], &v[2], &v[3], &v[4], &v[5],
                             &v[6], &v[7]);
            if (got < 3) continue;
            if (std::isnan(v[0]) || std::isnan(v[1]) || std::isnan(v[2]))
                continue;
            out[written * 4 + 0] = static_cast<float>(v[0]);
            out[written * 4 + 1] = static_cast<float>(v[1]);
            out[written * 4 + 2] = static_cast<float>(v[2]);
            out[written * 4 + 3] = got > 3 ? static_cast<float>(v[3]) : 0.f;
            written++;
        }
    }
    fclose(f);
    return written;
}

// Range-mask + stride-subsample + pad points into a fixed (max_out x 4)
// slot. mask_out (max_out bytes) marks valid rows. Returns count written.
// Deterministic stride subsampling replaces the reference's RNG shuffle
// (ref pcd_utils.shuffle_points + mask_points_by_range).
int64_t mask_pad_points(const float* pts, int64_t n,
                        const float* range6,  // xmin ymin zmin xmax ymax zmax
                        float ego_x_radius, float ego_y_radius,
                        float* out, uint8_t* mask_out, int64_t max_out) {
    // first pass: count in-range points to pick a keep stride
    int64_t in_range = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + i * 4;
        if (p[0] >= range6[0] && p[0] < range6[3] &&
            p[1] >= range6[1] && p[1] < range6[4] &&
            p[2] >= range6[2] && p[2] <= range6[5] &&
            !(fabsf(p[0]) < ego_x_radius && fabsf(p[1]) < ego_y_radius))
            in_range++;
    }
    double stride = in_range > max_out
        ? static_cast<double>(in_range) / max_out : 1.0;

    int64_t written = 0;
    double acc = 0.0;
    int64_t seen = 0;
    for (int64_t i = 0; i < n && written < max_out; ++i) {
        const float* p = pts + i * 4;
        if (!(p[0] >= range6[0] && p[0] < range6[3] &&
              p[1] >= range6[1] && p[1] < range6[4] &&
              p[2] >= range6[2] && p[2] <= range6[5]))
            continue;
        if (fabsf(p[0]) < ego_x_radius && fabsf(p[1]) < ego_y_radius)
            continue;
        seen++;
        acc += 1.0;
        if (acc < stride) continue;
        acc -= stride;
        memcpy(out + written * 4, p, 4 * sizeof(float));
        mask_out[written] = 1;
        written++;
    }
    for (int64_t i = written; i < max_out; ++i) mask_out[i] = 0;
    return written;
}

// Voxelize points into a fixed-capacity pillar table (the spconv
// VoxelGeneratorV2 host role, ref sp_voxel_preprocessor.py:22-60): each
// occupied (iy, ix) cell becomes a pillar holding up to max_pts points.
// Outputs:
//   pillar_pts    (max_pillars x max_pts x 4) float, zero padded
//   pillar_coords (max_pillars x 2) int32 (iy, ix), zero padded
//   pillar_npts   (max_pillars) int32
// scratch: caller-provided int32 grid of ny*nx entries (reused across
// calls; reset lazily via the epoch trick so no memset is needed).
// Returns the number of pillars written.
int64_t voxelize_pillars(const float* pts, int64_t n,
                         const float* range6, float vx, float vy,
                         int64_t nx, int64_t ny,
                         int64_t max_pillars, int64_t max_pts,
                         float* pillar_pts, int32_t* pillar_coords,
                         int32_t* pillar_npts,
                         int32_t* grid_slot, int32_t* grid_epoch,
                         int32_t epoch) {
    int64_t num_pillars = 0;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = pts + i * 4;
        if (!(p[0] >= range6[0] && p[0] < range6[3] &&
              p[1] >= range6[1] && p[1] < range6[4] &&
              p[2] >= range6[2] && p[2] <= range6[5]))
            continue;
        int64_t ix = static_cast<int64_t>((p[0] - range6[0]) / vx);
        int64_t iy = static_cast<int64_t>((p[1] - range6[1]) / vy);
        if (ix < 0 || ix >= nx || iy < 0 || iy >= ny) continue;
        int64_t cell = iy * nx + ix;
        int64_t slot;
        if (grid_epoch[cell] != epoch) {
            if (num_pillars >= max_pillars) continue;
            slot = num_pillars++;
            grid_epoch[cell] = epoch;
            grid_slot[cell] = static_cast<int32_t>(slot);
            pillar_coords[slot * 2 + 0] = static_cast<int32_t>(iy);
            pillar_coords[slot * 2 + 1] = static_cast<int32_t>(ix);
            pillar_npts[slot] = 0;
        } else {
            slot = grid_slot[cell];
        }
        int32_t cnt = pillar_npts[slot];
        if (cnt >= max_pts) continue;  // per-pillar cap, like the reference
        memcpy(pillar_pts + (slot * max_pts + cnt) * 4, p,
               4 * sizeof(float));
        pillar_npts[slot] = cnt + 1;
    }
    return num_pillars;
}

// Project points in place by a row-major 4x4 transform (xyz1 convention).
void transform_points(float* pts, int64_t n, const float* tfm) {
    for (int64_t i = 0; i < n; ++i) {
        float x = pts[i * 4], y = pts[i * 4 + 1], z = pts[i * 4 + 2];
        pts[i * 4 + 0] = tfm[0] * x + tfm[1] * y + tfm[2] * z + tfm[3];
        pts[i * 4 + 1] = tfm[4] * x + tfm[5] * y + tfm[6] * z + tfm[7];
        pts[i * 4 + 2] = tfm[8] * x + tfm[9] * y + tfm[10] * z + tfm[11];
    }
}

// Parse a batch of PCD files in parallel worker threads — the role of the
// reference's num_workers=4 torch DataLoader processes (ref
// opencood/tools/train.py:42): all of a frame's agent clouds (or a whole
// batch of frames) parse concurrently while the device runs the previous
// step. out is (n x max_points x 4), counts is (n) point counts (-1 on a
// per-file error). Returns the number of files parsed successfully.
int64_t parse_pcd_batch(const char* const* paths, int64_t n,
                        float* out, int64_t* counts,
                        int64_t max_points, int64_t n_threads) {
    if (n_threads <= 0) {
        n_threads = static_cast<int64_t>(
            std::thread::hardware_concurrency());
        if (n_threads <= 0) n_threads = 4;
    }
    if (n_threads > n) n_threads = n;
    std::atomic<int64_t> next(0), ok(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n) return;
            counts[i] = parse_pcd(paths[i], out + i * max_points * 4,
                                  max_points);
            if (counts[i] >= 0) ok.fetch_add(1);
        }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return ok.load();
}

}  // extern "C"
