// Native IO runtime of tensornetworksfork_tpu_torch: fast parsers for the
// host-side data path, idx-ubyte image files (MNIST format) and large numeric
// CSV files, behind a C ABI that native/__init__.py binds with ctypes. The
// same source as tensornetworksfork_tpu/native/tnf_io.cpp.
//
// Build (native/__init__.py does it at first use, into build/tnf_native/):
//   g++ -O3 -shared -fPIC tnf_io.cpp tnf_stream.cpp -o libtnf_io.so -lpthread

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parses an idx ubyte file. Returns total element count, or -1 on error.
// shape_out must have room for 4 dims; *ndim_out receives the rank.
// If out is null, only the header is parsed (size query).
long tnf_read_idx(const char* path, uint8_t* out, long out_capacity,
                  long* shape_out, int* ndim_out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t header[4];
    if (fread(header, 1, 4, f) != 4) { fclose(f); return -1; }
    // idx magic: two zero bytes then the type code (0x08 = ubyte)
    if (header[0] != 0 || header[1] != 0 || header[2] != 0x08) {
        fclose(f); return -1;
    }
    int ndim = header[3];
    if (ndim < 1 || ndim > 4) { fclose(f); return -1; }
    long total = 1;
    for (int i = 0; i < ndim; i++) {
        uint8_t dim[4];
        if (fread(dim, 1, 4, f) != 4) { fclose(f); return -1; }
        long d = ((long)dim[0] << 24) | ((long)dim[1] << 16) |
                 ((long)dim[2] << 8) | (long)dim[3];
        shape_out[i] = d;
        total *= d;
    }
    *ndim_out = ndim;
    if (out == nullptr) { fclose(f); return total; }
    if (total > out_capacity) { fclose(f); return -1; }
    long got = (long)fread(out, 1, (size_t)total, f);
    fclose(f);
    return got == total ? total : -1;
}

// Parses a numeric CSV (optional header row skipped when skip_header != 0).
// Writes row-major floats; returns the number of rows parsed, sets
// *ncols_out. Non-numeric and empty cells parse as 0 (one field per comma —
// consecutive commas are empty cells, not collapsed). Returns -1 on IO
// error, -2 when capacity is exceeded, -3 on a jagged row (column count
// differing from the first row — a silent reshape would scramble the data).
long tnf_parse_csv(const char* path, float* out, long capacity,
                   int* ncols_out, int skip_header) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    // read whole file
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc((size_t)size + 1);
    if (!buf) { fclose(f); return -1; }
    if ((long)fread(buf, 1, (size_t)size, f) != size) {
        free(buf); fclose(f); return -1;
    }
    buf[size] = '\0';
    fclose(f);

    long rows = 0, written = 0;
    int ncols = 0;
    char* p = buf;
    char* end = buf + size;
    if (skip_header) {
        while (p < end && *p != '\n') p++;
        if (p < end) p++;
    }
    while (p < end) {
        if (*p == '\n' || *p == '\r') { p++; continue; }  // blank line
        // whitespace-only lines (e.g. a trailing line of spaces) count as
        // blank too — they would otherwise parse as a 1-cell row and fail
        // the whole file with -3 (jagged row)
        char* q = p;
        while (q < end && (*q == ' ' || *q == '\t')) q++;
        if (q == end || *q == '\n' || *q == '\r') {
            p = (q < end) ? q + 1 : q;
            continue;
        }
        int cols = 0;
        for (;;) {
            // one field per iteration; empty or non-numeric fields emit 0.0.
            // Leading spaces/tabs are consumed HERE (not by strtof, whose
            // whitespace skipping includes '\n' and would read across the
            // line break on a whitespace-only or trailing empty cell).
            while (p < end && (*p == ' ' || *p == '\t')) p++;
            float v = 0.0f;
            char* next = p;
            if (p < end && *p != ',' && *p != '\n' && *p != '\r') {
                v = strtof(p, &next);
                if (next == p) v = 0.0f;
                while (next < end && *next != ',' && *next != '\n'
                       && *next != '\r') next++;  // skip non-numeric tail
            }
            if (written >= capacity) { free(buf); return -2; }
            out[written++] = v;
            cols++;
            p = next;
            if (p < end && *p == ',') { p++; continue; }  // exactly one comma
            break;
        }
        while (p < end && *p == '\r') p++;
        if (p < end && *p == '\n') p++;
        rows++;
        if (ncols == 0) ncols = cols;
        else if (cols != ncols) { free(buf); return -3; }  // jagged row
    }
    *ncols_out = ncols;
    free(buf);
    return rows;
}

}  // extern "C"
