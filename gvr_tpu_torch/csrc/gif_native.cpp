// GIF89a encoder with full LZW compression, exposed through a plain C ABI
// for ctypes (gvr_tpu_torch/io/gif.py).
//
// The port's own copy of the GIF part of gvr_tpu/native/gvr_native.cpp
// (gvr_gif_begin, gvr_gif_frame, gvr_gif_frame_indexed, gvr_gif_end and
// their helpers), the counterpart of the vendored gif-h encoder the
// reference uses (tests/main.cpp:77-115).  The same frames give the same
// bytes as that library.  Built at first use with the host C++ compiler
// into gvr_tpu_torch/_build/ (kernels/_build.py:host_library).

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// GIF89a encoder with real LZW compression
// ---------------------------------------------------------------------------

struct GifWriterState {
    FILE* f = nullptr;
    int w = 0, h = 0, delay = 4;
    // LZW sub-block staging
    uint8_t block[256];
    int block_len = 0;
    uint32_t bit_acc = 0;
    int bit_cnt = 0;
};

static void gif_flush_block(GifWriterState* g) {
    if (g->block_len > 0) {
        fputc(g->block_len, g->f);
        fwrite(g->block, 1, g->block_len, g->f);
        g->block_len = 0;
    }
}

static void gif_put_bits(GifWriterState* g, uint32_t code, int width) {
    g->bit_acc |= code << g->bit_cnt;
    g->bit_cnt += width;
    while (g->bit_cnt >= 8) {
        g->block[g->block_len++] = (uint8_t)(g->bit_acc & 0xff);
        g->bit_acc >>= 8;
        g->bit_cnt -= 8;
        if (g->block_len == 255) gif_flush_block(g);
    }
}

static void gif_finish_bits(GifWriterState* g) {
    if (g->bit_cnt > 0) {
        g->block[g->block_len++] = (uint8_t)(g->bit_acc & 0xff);
        if (g->block_len == 255) gif_flush_block(g);
    }
    g->bit_acc = 0;
    g->bit_cnt = 0;
    gif_flush_block(g);
}

static void write_u16(FILE* f, int v) {
    fputc(v & 0xff, f);
    fputc((v >> 8) & 0xff, f);
}

// 6x7x6 color cube palette (252 colors), matching the Python fallback
static void gif_palette(uint8_t pal[256][3]) {
    memset(pal, 0, 256 * 3);
    int idx = 0;
    for (int r = 0; r < 6; ++r)
        for (int gq = 0; gq < 7; ++gq)
            for (int b = 0; b < 6; ++b) {
                pal[idx][0] = (uint8_t)((r * 255 + 2) / 5);
                pal[idx][1] = (uint8_t)((gq * 255 + 3) / 6);
                pal[idx][2] = (uint8_t)((b * 255 + 2) / 5);
                ++idx;
            }
}

void* gvr_gif_begin(const char* path, int w, int h, int delay_cs) {
    FILE* f = fopen(path, "wb");
    if (!f) return nullptr;
    GifWriterState* g = new GifWriterState();
    g->f = f;
    g->w = w;
    g->h = h;
    g->delay = delay_cs;
    fwrite("GIF89a", 1, 6, f);
    write_u16(f, w);
    write_u16(f, h);
    fputc(0xF7, f);  // global color table, 8 bits, 256 entries
    fputc(0, f);
    fputc(0, f);
    uint8_t pal[256][3];
    gif_palette(pal);
    fwrite(pal, 1, 256 * 3, f);
    // netscape looping extension
    const uint8_t loop[] = {0x21, 0xff, 0x0b, 'N', 'E', 'T', 'S', 'C',
                            'A', 'P', 'E', '2', '.', '0', 0x03, 0x01,
                            0x00, 0x00, 0x00};
    fwrite(loop, 1, sizeof(loop), f);
    return g;
}

// frame header (GCE + image descriptor) and LZW body, shared by the
// fixed-palette and adaptive-palette entry points
static void gif_frame_header(GifWriterState* g, const uint8_t* local_pal) {
    FILE* f = g->f;
    const uint8_t gce[] = {0x21, 0xf9, 0x04, 0x04};
    fwrite(gce, 1, sizeof(gce), f);
    write_u16(f, g->delay);
    fputc(0, f);
    fputc(0, f);
    fputc(0x2c, f);
    write_u16(f, 0);
    write_u16(f, 0);
    write_u16(f, g->w);
    write_u16(f, g->h);
    if (local_pal) {
        fputc(0x87, f);  // local color table, 256 entries
        fwrite(local_pal, 1, 256 * 3, f);
    } else {
        fputc(0, f);
    }
}

static void gif_lzw_body(GifWriterState* g, const uint8_t* idx, long npix);

int gvr_gif_frame(void* handle, const unsigned char* rgba) {
    GifWriterState* g = (GifWriterState*)handle;
    if (!g || !g->f) return -1;
    const long npix = (long)g->w * g->h;

    // quantize to the 6x7x6 cube
    std::vector<uint8_t> idx(npix);
    for (long i = 0; i < npix; ++i) {
        int r = (rgba[4 * i + 0] * 5 + 127) / 255;
        int gq = (rgba[4 * i + 1] * 6 + 127) / 255;
        int b = (rgba[4 * i + 2] * 5 + 127) / 255;
        idx[i] = (uint8_t)(r * 42 + gq * 6 + b);
    }
    gif_frame_header(g, nullptr);
    gif_lzw_body(g, idx.data(), npix);
    return 0;
}

// adaptive per-frame palette path (gif-h quality model): caller supplies
// palette indices + a 256-entry local color table
int gvr_gif_frame_indexed(void* handle, const unsigned char* idx,
                          const unsigned char* pal768) {
    GifWriterState* g = (GifWriterState*)handle;
    if (!g || !g->f) return -1;
    gif_frame_header(g, pal768);
    gif_lzw_body(g, idx, (long)g->w * g->h);
    return 0;
}

static void gif_lzw_body(GifWriterState* g, const uint8_t* idx, long npix) {
    FILE* f = g->f;
    // --- LZW compress ---
    const int MIN_CODE = 8;
    const int CLEAR = 1 << MIN_CODE;        // 256
    const int END = CLEAR + 1;              // 257
    const int MAX_CODE = 4096;
    fputc(MIN_CODE, f);

    // dictionary: child[code][symbol] via open-addressed hash of
    // (prefix_code << 8 | symbol)
    const int HSIZE = 1 << 14;
    std::vector<int32_t> hash_key(HSIZE, -1);
    std::vector<int16_t> hash_val(HSIZE, 0);

    auto reset_dict = [&]() {
        std::fill(hash_key.begin(), hash_key.end(), -1);
    };

    int code_width = MIN_CODE + 1;
    int next_code = END + 1;
    reset_dict();
    gif_put_bits(g, CLEAR, code_width);

    int32_t prefix = idx[0];
    for (long i = 1; i < npix; ++i) {
        int sym = idx[i];
        int32_t key = (prefix << 8) | sym;
        uint32_t hpos = ((uint32_t)key * 2654435761u) & (HSIZE - 1);
        int found = -1;
        while (hash_key[hpos] != -1) {
            if (hash_key[hpos] == key) { found = hash_val[hpos]; break; }
            hpos = (hpos + 1) & (HSIZE - 1);
        }
        if (found >= 0) {
            prefix = found;
            continue;
        }
        // emit prefix, add (prefix, sym) to the dictionary
        gif_put_bits(g, (uint32_t)prefix, code_width);
        if (next_code < MAX_CODE) {
            hash_key[hpos] = key;
            hash_val[hpos] = (int16_t)next_code;
            if (next_code == (1 << code_width) && code_width < 12)
                ++code_width;
            ++next_code;
        } else {
            gif_put_bits(g, CLEAR, code_width);
            code_width = MIN_CODE + 1;
            next_code = END + 1;
            reset_dict();
        }
        prefix = sym;
    }
    gif_put_bits(g, (uint32_t)prefix, code_width);
    gif_put_bits(g, END, code_width);
    gif_finish_bits(g);
    fputc(0, f);  // block terminator
}

int gvr_gif_end(void* handle) {
    GifWriterState* g = (GifWriterState*)handle;
    if (!g) return -1;
    if (g->f) {
        fputc(0x3b, g->f);
        fclose(g->f);
    }
    delete g;
    return 0;
}

}  // extern "C"
