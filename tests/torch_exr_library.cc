// OpenEXR's own writer and reader for the EXR fixtures: files written by
// the library (scan-line, tiled at every level and rounding mode,
// multi-part, deep, UINT, subsampled) and its `Imf::InputFile` decode with
// FLOAT slices, the call cv2's EXR decoder makes. Built by
// `tests/torch_exr_library.py` with g++ against the host's OpenEXR 3.1
// headers; tier-1 never builds it (the committed fixtures and
// `expected.npz` hold its output).

#include <ImfChannelList.h>
#include <ImfDeepFrameBuffer.h>
#include <ImfDeepScanLineOutputPart.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImfInputFile.h>
#include <ImfMultiPartOutputFile.h>
#include <ImfOutputPart.h>
#include <ImfPartType.h>
#include <ImfTiledOutputPart.h>
#include <ImfTileDescription.h>
#include <ImfCompression.h>
#include <ImfLineOrder.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

using namespace OPENEXR_IMF_NAMESPACE;
using IMATH_NAMESPACE::Box2i;
using IMATH_NAMESPACE::V2i;

namespace {

enum {
  P_X0, P_Y0, P_W, P_H, P_COMPRESSION, P_LINE_ORDER, P_TILED, P_TX, P_TY,
  P_LEVEL_MODE, P_ROUNDING, P_CHANNELS, P_DEEP, P_FIELDS
};
enum { C_TYPE, C_PLINEAR, C_XS, C_YS, C_FIELDS };

size_t type_size(int t) { return t == HALF ? 2 : 4; }

// Fill a level other than (0, 0) with `value` in the channel's type.
std::vector<char> constant_level(int type, size_t n, float value) {
  std::vector<char> out(n * type_size(type));
  for (size_t i = 0; i < n; ++i) {
    if (type == HALF) {
      half h(value);
      std::memcpy(&out[2 * i], &h, 2);
    } else if (type == FLOAT) {
      std::memcpy(&out[4 * i], &value, 4);
    } else {
      uint32_t u = (uint32_t)value;
      std::memcpy(&out[4 * i], &u, 4);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Write `n_parts` parts to `path` (one part and no multi-part flag when
// n_parts is 1). part_info holds P_FIELDS ints a part, dwa_levels a float
// a part, names the channels' names NUL-separated, chan_info C_FIELDS ints
// a channel, data a pointer a channel to its (h / ys, w / xs) samples of
// level (0, 0); the coarser levels of a tiled part hold 5 + lx + 16 * ly.
// Deep parts hold 1 + (x + y) % 3 samples a pixel, each the pixel's value.
// Returns 0, or -1 with the library's message in `err`.
int exr_write(const char *path, int n_parts, const int *part_info,
              const float *dwa_levels, const char *names,
              const int *chan_info, const void *const *data, char *err,
              int err_cap) {
  try {
    std::vector<Header> headers;
    const char *name = names;
    int c0 = 0;
    std::vector<std::vector<std::string>> part_names(n_parts);
    for (int p = 0; p < n_parts; ++p) {
      const int *pi = part_info + p * P_FIELDS;
      Box2i dw(V2i(pi[P_X0], pi[P_Y0]),
               V2i(pi[P_X0] + pi[P_W] - 1, pi[P_Y0] + pi[P_H] - 1));
      // parts share the display window (the first part's data window)
      const int *p0 = part_info;
      Box2i disp(V2i(p0[P_X0], p0[P_Y0]),
                 V2i(p0[P_X0] + p0[P_W] - 1, p0[P_Y0] + p0[P_H] - 1));
      Header h(disp, dw, 1.f, IMATH_NAMESPACE::V2f(0, 0), 1.f,
               (LineOrder)pi[P_LINE_ORDER], (Compression)pi[P_COMPRESSION]);
      for (int c = 0; c < pi[P_CHANNELS]; ++c) {
        const int *ci = chan_info + (c0 + c) * C_FIELDS;
        h.channels().insert(name, Channel((PixelType)ci[C_TYPE], ci[C_XS],
                                          ci[C_YS], ci[C_PLINEAR] != 0));
        part_names[p].push_back(name);
        name += std::strlen(name) + 1;
      }
      c0 += pi[P_CHANNELS];
      h.dwaCompressionLevel() = dwa_levels[p];
      if (n_parts > 1) h.setName("part" + std::to_string(p));
      if (pi[P_DEEP]) {
        h.setType(DEEPSCANLINE);
      } else if (pi[P_TILED]) {
        h.setTileDescription(TileDescription(
            pi[P_TX], pi[P_TY], (LevelMode)pi[P_LEVEL_MODE],
            (LevelRoundingMode)pi[P_ROUNDING]));
        h.setType(TILEDIMAGE);
      } else {
        h.setType(SCANLINEIMAGE);
      }
      headers.push_back(h);
    }
    MultiPartOutputFile file(path, headers.data(), n_parts);
    c0 = 0;
    for (int p = 0; p < n_parts; ++p) {
      const int *pi = part_info + p * P_FIELDS;
      int x0 = pi[P_X0], y0 = pi[P_Y0], w = pi[P_W], hgt = pi[P_H];
      int nc = pi[P_CHANNELS];
      if (pi[P_DEEP]) {
        DeepScanLineOutputPart part(file, p);
        std::vector<unsigned int> counts((size_t)w * hgt);
        for (int y = 0; y < hgt; ++y)
          for (int x = 0; x < w; ++x) counts[(size_t)y * w + x] = 1 + (x + y) % 3;
        std::vector<std::vector<char *>> ptrs(nc);
        std::vector<std::vector<char>> store(nc);
        DeepFrameBuffer fb;
        fb.insertSampleCountSlice(Slice(
            UINT, (char *)(counts.data() - x0 - (size_t)y0 * w),
            sizeof(unsigned), sizeof(unsigned) * w));
        for (int c = 0; c < nc; ++c) {
          const int *ci = chan_info + (c0 + c) * C_FIELDS;
          size_t ts = type_size(ci[C_TYPE]);
          const char *src = (const char *)data[c0 + c];
          size_t total = 0;
          for (unsigned n : counts) total += n;
          store[c].resize(total * ts);
          ptrs[c].resize((size_t)w * hgt);
          size_t at = 0;
          for (size_t i = 0; i < counts.size(); ++i) {
            ptrs[c][i] = &store[c][at * ts];
            for (unsigned k = 0; k < counts[i]; ++k, ++at)
              std::memcpy(&store[c][at * ts], src + i * ts, ts);
          }
          fb.insert(part_names[p][c], DeepSlice(
              (PixelType)ci[C_TYPE],
              (char *)(ptrs[c].data() - x0 - (size_t)y0 * w),
              sizeof(char *), sizeof(char *) * w, ts));
        }
        part.setFrameBuffer(fb);
        part.writePixels(hgt);
      } else if (pi[P_TILED]) {
        TiledOutputPart part(file, p);
        std::vector<std::vector<char>> levels;
        for (int ly = 0; ly < part.numYLevels(); ++ly) {
          for (int lx = 0; lx < part.numXLevels(); ++lx) {
            if (!part.isValidLevel(lx, ly)) continue;
            Box2i lw = part.dataWindowForLevel(lx, ly);
            int lw_w = lw.max.x - lw.min.x + 1, lw_h = lw.max.y - lw.min.y + 1;
            FrameBuffer fb;
            for (int c = 0; c < nc; ++c) {
              const int *ci = chan_info + (c0 + c) * C_FIELDS;
              size_t ts = type_size(ci[C_TYPE]);
              const char *base;
              if (lx == 0 && ly == 0) {
                base = (const char *)data[c0 + c];
              } else {
                levels.push_back(constant_level(ci[C_TYPE],
                                                (size_t)lw_w * lw_h,
                                                5.f + lx + 16.f * ly));
                base = levels.back().data();
              }
              fb.insert(part_names[p][c], Slice(
                  (PixelType)ci[C_TYPE],
                  (char *)(base - (lw.min.x + (ptrdiff_t)lw.min.y * lw_w) * ts),
                  ts, ts * lw_w));
            }
            part.setFrameBuffer(fb);
            part.writeTiles(0, part.numXTiles(lx) - 1, 0,
                            part.numYTiles(ly) - 1, lx, ly);
          }
        }
      } else {
        OutputPart part(file, p);
        FrameBuffer fb;
        for (int c = 0; c < nc; ++c) {
          const int *ci = chan_info + (c0 + c) * C_FIELDS;
          size_t ts = type_size(ci[C_TYPE]);
          int xs = ci[C_XS], ys = ci[C_YS];
          int cw = w / xs;
          fb.insert(part_names[p][c], Slice(
              (PixelType)ci[C_TYPE],
              (char *)((const char *)data[c0 + c]
                       - (x0 / xs + (ptrdiff_t)(y0 / ys) * cw) * ts),
              ts, ts * cw, xs, ys));
        }
        part.setFrameBuffer(fb);
        part.writePixels(hgt);
      }
      c0 += nc;
    }
    return 0;
  } catch (const std::exception &e) {
    std::snprintf(err, err_cap, "%s", e.what());
    return -1;
  }
}

// The first part's channels as `Imf::InputFile` gives them with a FLOAT
// slice each: info = {x0, y0, w, h, n_channels}, names NUL-separated in
// the header's (alphabetical) order, out (n_channels, h, w) float32 when
// not null. Returns 0, or -1 with the library's message in `err`.
int exr_read(const char *path, int *info, char *names, int names_cap,
             float *out, char *err, int err_cap) {
  try {
    InputFile file(path);
    const Header &h = file.header();
    Box2i dw = h.dataWindow();
    int w = dw.max.x - dw.min.x + 1, hgt = dw.max.y - dw.min.y + 1;
    int n = 0, at = 0;
    FrameBuffer fb;
    for (ChannelList::ConstIterator c = h.channels().begin();
         c != h.channels().end(); ++c, ++n) {
      int len = (int)std::strlen(c.name()) + 1;
      if (at + len <= names_cap) std::memcpy(names + at, c.name(), len);
      at += len;
      if (out) {
        float *plane = out + (size_t)n * w * hgt;
        fb.insert(c.name(), Slice(
            FLOAT, (char *)(plane - dw.min.x - (ptrdiff_t)dw.min.y * w),
            sizeof(float), sizeof(float) * w));
      }
    }
    info[0] = dw.min.x; info[1] = dw.min.y; info[2] = w; info[3] = hgt;
    info[4] = n;
    if (out) {
      file.setFrameBuffer(fb);
      file.readPixels(dw.min.y, dw.max.y);
    }
    return 0;
  } catch (const std::exception &e) {
    std::snprintf(err, err_cap, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
