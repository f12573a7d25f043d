/* Frame rasterizer: the recording pipeline's host-side loop.
 *
 * The reference renders with one pygame draw call per particle (its
 * playback.py:178-206); render.py's numpy rasterizer vectorizes that and is
 * the pixel oracle of this file.  This splats pressure-tinted disks and 2px
 * segment lines straight into an RGB buffer.
 *
 * Built at first use by native/__init__.py (gcc -O3 -shared -fPIC) into the
 * package's _build/ and bound with ctypes.
 */

#include <math.h>
#include <stdint.h>
#include <string.h>

void rasterize(
    const float *pos,        /* (n, 2) crate coords in [0, 1]^2 */
    const float *pressure,   /* (n,) */
    const uint8_t *alive,    /* (n,) 0/1 */
    long n,
    const float *segments,   /* (s, 2, 2) */
    long s,
    long w,
    long h,
    long r_px,               /* particle radius in pixels */
    uint8_t *out             /* (h, w, 3), zeroed or reused */
) {
    memset(out, 0, (size_t)(h * w * 3));

    /* pressure-tinted disks: (tint, tint, 255), tint = 255 * (1 - clip(p)) */
    long r = r_px > 0 ? r_px : 0;
    long r2 = (r > 0 ? r : 1) * (r > 0 ? r : 1);
    for (long i = 0; i < n; ++i) {
        if (!alive[i]) continue;
        float p = pressure[i];
        if (p < 0.f) p = 0.f;
        if (p > 1.f) p = 1.f;
        uint8_t tint = (uint8_t)(255.f - p * 255.f);
        long px = (long)(pos[2 * i] * (float)(w - 1));
        long py = (long)(pos[2 * i + 1] * (float)(h - 1));
        if (px < 0) px = 0;
        if (px > w - 1) px = w - 1;
        if (py < 0) py = 0;
        if (py > h - 1) py = h - 1;
        for (long dy = -r; dy <= r; ++dy) {
            long y = py + dy;
            if (y < 0) y = 0;
            if (y > h - 1) y = h - 1;
            uint8_t *row = out + (size_t)(y * w) * 3;
            for (long dx = -r; dx <= r; ++dx) {
                if (dx * dx + dy * dy > r2 && r > 0) continue;
                long x = px + dx;
                if (x < 0) x = 0;
                if (x > w - 1) x = w - 1;
                uint8_t *px3 = row + (size_t)x * 3;
                px3[0] = tint;
                px3[1] = tint;
                px3[2] = 255;
            }
        }
    }

    /* white segments, 2px like the reference (playback.py:185) */
    for (long j = 0; j < s; ++j) {
        float ax = segments[j * 4], ay = segments[j * 4 + 1];
        float bx = segments[j * 4 + 2], by = segments[j * 4 + 3];
        float dx = (bx - ax) * (float)w, dy = (by - ay) * (float)h;
        float len = fabsf(dx) > fabsf(dy) ? fabsf(dx) : fabsf(dy);
        if (len < 1.f) len = 1.f;
        long steps = (long)len + 1;  /* matches the numpy linspace sampling */
        if (steps < 2) steps = 2;
        for (long k = 0; k < steps; ++k) {
            float t = (float)k / (float)(steps - 1);
            long x = (long)((ax + (bx - ax) * t) * (float)(w - 1));
            long y = (long)((ay + (by - ay) * t) * (float)(h - 1));
            if (x < 0) x = 0;
            if (x > w - 1) x = w - 1;
            for (long d = -1; d <= 0; ++d) {
                long yy = y + d;
                if (yy < 0) yy = 0;
                if (yy > h - 1) yy = h - 1;
                uint8_t *px3 = out + ((size_t)(yy * w) + (size_t)x) * 3;
                px3[0] = 255;
                px3[1] = 255;
                px3[2] = 255;
            }
        }
    }
}
