/* Reverses the five PNG row filters (None, Sub, Up, Average, Paeth) of a
 * non-interlaced image: host code of the port's PNG decoder
 * (sar_yolo_tpu_torch/data/imageio.py), built with the system C compiler at
 * first use and loaded with ctypes.
 *
 * Average and Paeth predict each byte from the reconstructed byte to its left,
 * so a row is a chain of dependent bytes; this loop runs it at memory speed.
 */
#include <stdint.h>
#include <string.h>

/* src: rows x (1 + row_bytes) filtered bytes, each row led by its filter type.
 * dst: rows x row_bytes reconstructed bytes. bpp: bytes per complete pixel
 * (at least 1). Returns 0, or -1 for a filter type outside 0-4. */
int png_unfilter(const uint8_t *src, uint8_t *dst, int rows, int row_bytes, int bpp) {
    const uint8_t *prev = NULL;
    for (int y = 0; y < rows; y++, src += row_bytes + 1, dst += row_bytes) {
        const uint8_t *f = src + 1;
        uint8_t *r = dst;
        int x;
        switch (src[0]) {
        case 0:
            memcpy(r, f, (size_t)row_bytes);
            break;
        case 1:
            for (x = 0; x < row_bytes; x++)
                r[x] = (uint8_t)(f[x] + (x >= bpp ? r[x - bpp] : 0));
            break;
        case 2:
            for (x = 0; x < row_bytes; x++)
                r[x] = (uint8_t)(f[x] + (prev ? prev[x] : 0));
            break;
        case 3:
            for (x = 0; x < row_bytes; x++) {
                int a = x >= bpp ? r[x - bpp] : 0, b = prev ? prev[x] : 0;
                r[x] = (uint8_t)(f[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (x = 0; x < row_bytes; x++) {
                int a = x >= bpp ? r[x - bpp] : 0, b = prev ? prev[x] : 0;
                int c = (x >= bpp && prev) ? prev[x - bpp] : 0;
                int p = a + b - c;
                int pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
                    pc = p > c ? p - c : c - p;
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                r[x] = (uint8_t)(f[x] + pred);
            }
            break;
        default:
            return -1;
        }
        prev = r;
    }
    return 0;
}
