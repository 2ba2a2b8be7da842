// Native field I/O — this framework's analogue of the reference's only
// shared library, lib/libfieldio.so (reference: src/fieldio.cpp:7-33,
// Makefile:11,26-27). Same byte contract: raw headerless little-endian
// float32, whole field, x-major/y-contiguous.
//
// Differences by design (SURVEY.md §5.10-4): the reference never checks
// fopen() for NULL and mis-tests fread's return; here every path returns a
// count the Python caller validates, so a missing/short file raises instead
// of segfaulting.

#include <cstdio>
#include <cstring>

extern "C" {

// Write n float32s to filename. Returns the number written, or -1 on open
// failure. (reference writeField, fieldio.cpp:7-19)
long xfb_write_field(const char *filename, const void *data, size_t n) {
    FILE *f = std::fopen(filename, "wb");
    if (f == nullptr) return -1;
    size_t written = std::fwrite(data, sizeof(float), n, f);
    std::fclose(f);
    return (long)written;
}

// Read up to n float32s from filename into data. Returns the number read,
// or -1 on open failure. (reference readField, fieldio.cpp:21-33)
long xfb_read_field(const char *filename, void *data, size_t n) {
    FILE *f = std::fopen(filename, "rb");
    if (f == nullptr) return -1;
    size_t got = std::fread(data, sizeof(float), n, f);
    std::fclose(f);
    return (long)got;
}

}  // extern "C"
