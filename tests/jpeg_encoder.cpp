// A small command-line JPEG encoder over a libjpeg(-turbo) shared library
// named at run time, for the JPEG tests' fixtures: arithmetic coding
// (SOF9/SOF10) and lossless files (SOF3, libjpeg-turbo 3's
// jpeg_enable_lossless), which Pillow's encoder does not write.
//
//   jpeg_encoder LIBRARY WIDTH HEIGHT COMPONENTS IN_SPACE JPEG_SPACE QUALITY ARITH
//                PROGRESSIVE RESTART PSV PT SAMPLING < samples > file.jpg
//
// IN_SPACE and JPEG_SPACE are J_COLOR_SPACE numbers (1 grey, 2 RGB, 3
// YCbCr, 4 CMYK, 5 YCCK); PSV 0 writes a DCT file, 1-7 a lossless one
// with point transform PT; SAMPLING is "h,v,h,v..." for each component
// (or "-" for the library's default). The samples are HEIGHT rows of
// WIDTH x COMPONENTS bytes. Built by g++ at the tests' first use of it.

#include <dlfcn.h>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct Fail {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void fail_exit(j_common_ptr cinfo) {
  char message[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, message);
  std::fprintf(stderr, "libjpeg: %s\n", message);
  std::longjmp(reinterpret_cast<Fail*>(cinfo->err)->jump, 1);
}

template <typename F>
F need(void* lib, const char* name) {
  void* f = dlsym(lib, name);
  if (!f) {
    std::fprintf(stderr, "%s has no %s\n", "library", name);
    std::exit(3);
  }
  return reinterpret_cast<F>(f);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 14) {
    std::fprintf(stderr, "usage: see the head of jpeg_encoder.cpp\n");
    return 2;
  }
  void* lib = dlopen(argv[1], RTLD_NOW | RTLD_LOCAL);
  if (!lib) {
    std::fprintf(stderr, "%s\n", dlerror());
    return 3;
  }
  const int width = std::atoi(argv[2]), height = std::atoi(argv[3]);
  const int ncomp = std::atoi(argv[4]), in_space = std::atoi(argv[5]);
  const int jpeg_space = std::atoi(argv[6]), quality = std::atoi(argv[7]);
  const int arith = std::atoi(argv[8]), progressive = std::atoi(argv[9]);
  const int restart = std::atoi(argv[10]), psv = std::atoi(argv[11]), pt = std::atoi(argv[12]);
  std::vector<unsigned char> px(static_cast<size_t>(width) * height * ncomp);
  if (std::fread(px.data(), 1, px.size(), stdin) != px.size()) {
    std::fprintf(stderr, "short input\n");
    return 2;
  }

  auto std_error = need<jpeg_error_mgr* (*)(jpeg_error_mgr*)>(lib, "jpeg_std_error");
  auto create = need<void (*)(j_compress_ptr, int, size_t)>(lib, "jpeg_CreateCompress");
  auto defaults = need<void (*)(j_compress_ptr)>(lib, "jpeg_set_defaults");
  auto colorspace = need<void (*)(j_compress_ptr, J_COLOR_SPACE)>(lib, "jpeg_set_colorspace");
  auto set_quality = need<void (*)(j_compress_ptr, int, boolean)>(lib, "jpeg_set_quality");
  auto simple_progression = need<void (*)(j_compress_ptr)>(lib, "jpeg_simple_progression");
  auto mem_dest = need<void (*)(j_compress_ptr, unsigned char**, unsigned long*)>(
      lib, "jpeg_mem_dest");
  auto start = need<void (*)(j_compress_ptr, boolean)>(lib, "jpeg_start_compress");
  auto write = need<JDIMENSION (*)(j_compress_ptr, JSAMPARRAY, JDIMENSION)>(
      lib, "jpeg_write_scanlines");
  auto finish = need<void (*)(j_compress_ptr)>(lib, "jpeg_finish_compress");
  auto destroy = need<void (*)(j_compress_ptr)>(lib, "jpeg_destroy_compress");

  jpeg_compress_struct cinfo;
  Fail err;
  cinfo.err = std_error(&err.pub);
  err.pub.error_exit = fail_exit;
  unsigned char* out = nullptr;
  unsigned long size = 0;
  if (setjmp(err.jump)) {
    destroy(&cinfo);
    return 1;
  }
  create(&cinfo, JPEG_LIB_VERSION, sizeof(cinfo));
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = ncomp;
  cinfo.in_color_space = static_cast<J_COLOR_SPACE>(in_space);
  defaults(&cinfo);
  colorspace(&cinfo, static_cast<J_COLOR_SPACE>(jpeg_space));
  if (psv) {
    auto lossless = need<void (*)(j_compress_ptr, int, int)>(lib, "jpeg_enable_lossless");
    lossless(&cinfo, psv, pt);
  } else {
    set_quality(&cinfo, quality, TRUE);
    if (progressive) simple_progression(&cinfo);
  }
  cinfo.arith_code = arith ? TRUE : FALSE;
  cinfo.optimize_coding = FALSE;
  cinfo.restart_interval = restart;
  if (std::strcmp(argv[13], "-") != 0) {
    const char* s = argv[13];
    for (int c = 0; c < cinfo.num_components; ++c) {
      int h = 0, v = 0, n = 0;
      if (std::sscanf(s, "%d,%d%n", &h, &v, &n) != 2) {
        std::fprintf(stderr, "bad sampling %s\n", argv[13]);
        return 2;
      }
      cinfo.comp_info[c].h_samp_factor = h;
      cinfo.comp_info[c].v_samp_factor = v;
      s += n;
      if (*s == ',') ++s;
    }
  }
  mem_dest(&cinfo, &out, &size);
  start(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = px.data() + static_cast<size_t>(cinfo.next_scanline) * width * ncomp;
    write(&cinfo, &row, 1);
  }
  finish(&cinfo);
  std::fwrite(out, 1, size, stdout);
  destroy(&cinfo);
  std::free(out);
  return 0;
}
