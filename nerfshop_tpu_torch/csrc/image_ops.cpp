// PNG row unfiltering for the port's own PNG reader (data/image_io.py),
// bound with ctypes by nerfshop_tpu_torch/native.py, which builds it with
// g++ at first use.
//
// The PNG row filters Sub, Average and Paeth read the byte decoded just
// before in the same row, so they cannot be vectorized across a row in
// numpy; a Python loop costs seconds an image. This walks the inflated
// IDAT stream row by row and undoes all five filters (PNG specification,
// section 9: None, Sub, Up, Average, Paeth), with `bpp` the bytes of one
// pixel rounded up to one byte.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// src: `height` rows of 1 filter byte + `stride` bytes; dst: height × stride.
// Returns 0, or the 1-based row whose filter byte is not 0-4.
int64_t png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height, int64_t stride, int bpp) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = src + y * (stride + 1);
        const uint8_t filter = in[0];
        ++in;
        uint8_t* out = dst + y * stride;
        switch (filter) {
            case 0:
                std::memcpy(out, in, (size_t)stride);
                break;
            case 1:
                for (int64_t i = 0; i < stride; ++i) out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i) out[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? out[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? out[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                    const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    out[i] = (uint8_t)(in[i] + pred);
                }
                break;
            default:
                return y + 1;
        }
        prev = out;
    }
    return 0;
}

}  // extern "C"
