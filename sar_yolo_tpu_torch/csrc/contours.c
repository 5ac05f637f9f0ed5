/* The outer contours of a binary mask: host code of the port's mask contours
 * (sar_yolo_tpu_torch/data/cv.py, find_contours_external), built with the system C
 * compiler at first use and loaded with ctypes.
 *
 * A copy of OpenCV's cvFindNextContour / icvFetchContour (Suzuki-Abe border following)
 * for mode RETR_EXTERNAL and CHAIN_APPROX_SIMPLE on an 8-bit image: the mask is
 * binarized (nonzero -> 1) inside a border of zeros; rows are scanned top to bottom,
 * left to right; a 0 -> 1 step starts an outer border unless the last border pixel
 * passed on this row is marked positive (the scan is then inside an object); holes are
 * never followed. Each border is followed clockwise in image coordinates from its first
 * pixel, its pixels marked 2, or -126 where the pixel to the right was found 0; a point
 * is kept where the chain code changes. Contours come out in the order found.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static const int code_dx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
static const int code_dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

/* mask: h x w bytes. points: room for cap (x, y) pairs; counts: room for max_contours.
 * Returns the number of contours and sets *total to the number of points they need;
 * nothing past cap points or max_contours counts is written (the caller retries with
 * more room). -2: out of memory. */
long find_contours_external(const uint8_t *mask, int h, int w, int32_t *points, long cap,
                            int32_t *counts, long max_contours, long *total) {
    long step = (long)w + 2;
    int8_t *img = (int8_t *)calloc((size_t)(step * (h + 2)), 1);
    if (!img)
        return -2;
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++)
            img[(y + 1) * step + x + 1] = mask[(long)y * w + x] != 0;
    long deltas[16];
    deltas[0] = 1, deltas[1] = -step + 1, deltas[2] = -step, deltas[3] = -step - 1;
    deltas[4] = -1, deltas[5] = step - 1, deltas[6] = step, deltas[7] = step + 1;
    memcpy(deltas + 8, deltas, 8 * sizeof(long));
    long ncont = 0, npts = 0;
    const int8_t nbd = 2;
    for (int y = 1; y <= h; y++) {
        int8_t *row = img + y * step;
        int prev = 0;
        long lnbd = y * step; /* the last border pixel passed on this row */
        for (int x = 1; x <= w; x++) {
            int p = row[x];
            if (p == prev)
                continue;
            if (prev == 0 && p == 1 && img[lnbd] <= 0) {
                /* follow the outer border that starts at (x, y) */
                int8_t *i0 = row + x, *i1, *i3, *i4 = 0;
                int s, s_end, prev_s;
                int px = x - 1, py = y - 1;
                long start = npts;
                s_end = s = 4;
                do {
                    s = (s - 1) & 7;
                    i1 = i0 + deltas[s];
                } while (*i1 == 0 && s != s_end);
                if (s == s_end) { /* a single pixel */
                    *i0 = (int8_t)(nbd | -128);
                    if (npts < cap)
                        points[2 * npts] = px, points[2 * npts + 1] = py;
                    npts++;
                } else {
                    i3 = i0;
                    prev_s = s ^ 4;
                    for (;;) {
                        s_end = s;
                        while (s < 15) {
                            i4 = i3 + deltas[++s];
                            if (*i4 != 0)
                                break;
                        }
                        s &= 7;
                        if ((unsigned)(s - 1) < (unsigned)s_end)
                            *i3 = (int8_t)(nbd | -128);
                        else if (*i3 == 1)
                            *i3 = nbd;
                        if (s != prev_s) {
                            if (npts < cap)
                                points[2 * npts] = px, points[2 * npts + 1] = py;
                            npts++;
                            prev_s = s;
                        }
                        px += code_dx[s];
                        py += code_dy[s];
                        if (i4 == i0 && i3 == i1)
                            break;
                        i3 = i4;
                        s = (s + 4) & 7;
                    }
                }
                if (ncont < max_contours)
                    counts[ncont] = (int32_t)(npts - start);
                ncont++;
                lnbd = y * step + x;
                prev = row[x]; /* the scan resumes after the marked start pixel */
                continue;
            }
            prev = p;
            if (prev & -2)
                lnbd = y * step + x;
        }
    }
    free(img);
    *total = npts;
    return ncont;
}
