// JPEG decoding on the card with nvJPEG (the CUDA toolkit's libnvjpeg), for
// the latent extraction's image reader (tinyedm_tpu_torch/data/images.py).
//
// Not the port of a TPU kernel: the JAX package decodes JPEGs on the host
// with PIL (tinyedm_tpu/data/extract_latents.py:101), and the machine with
// the card has no PIL. nvJPEG's simple API decodes one image into its Y, Cb
// and Cr planes at their own (subsampled) sizes on the caller's stream: the
// Huffman stage on the host inside the call, the IDCT on the card. The
// wrapper then upsamples the chroma and converts to RGB with libjpeg's own
// arithmetic ("fancy" triangle upsampling, the fixed-point YCbCr tables), as
// PIL's decoder does, in torch on the card: nvJPEG's own RGB output repeats
// chroma samples, or interpolates them otherwise than libjpeg.
//
// A decoder is one handle and one decode state (tinyedm_jpeg_create); the
// Python wrapper holds a lock around every call on it, since a state is not
// shared between concurrent decodes.
//
// Return codes: 0; a negative nvjpegStatus_t (-status); or a positive
// cudaError_t (tinyedm_error_string names it).
#include <nvjpeg.h>

#include "common.cuh"

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

int status(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : -static_cast<int>(s); }

}  // namespace

// a decoder on the default backend; *out receives it
extern "C" int tinyedm_jpeg_create(void** out) {
  Decoder* d = new Decoder();
  int err = status(nvjpegCreateSimple(&d->handle));
  if (!err) err = status(nvjpegJpegStateCreate(d->handle, &d->state));
  if (err) {
    if (d->handle) nvjpegDestroy(d->handle);
    delete d;
    return err;
  }
  *out = d;
  return 0;
}

extern "C" void tinyedm_jpeg_destroy(void* decoder) {
  Decoder* d = static_cast<Decoder*>(decoder);
  if (!d) return;
  if (d->state) nvjpegJpegStateDestroy(d->state);
  if (d->handle) nvjpegDestroy(d->handle);
  delete d;
}

// the number of components, the nvjpegChromaSubsampling_t and the size of
// every component (widths[4], heights[4]) of a JPEG held in host memory
extern "C" int tinyedm_jpeg_info(void* decoder, const unsigned char* data, size_t length, int* components,
                                 int* subsampling, int* widths, int* heights) {
  Decoder* d = static_cast<Decoder*>(decoder);
  nvjpegChromaSubsampling_t css;
  int err = status(nvjpegGetImageInfo(d->handle, data, length, components, &css, widths, heights));
  if (!err) *subsampling = static_cast<int>(css);
  return err;
}

// decode into the planes Y, Cb, Cr on the card, one byte a sample, each with
// its pitch (a grey JPEG fills Y alone; cb and cr may then be null)
extern "C" int tinyedm_jpeg_decode_planes(void* decoder, const unsigned char* data, size_t length,
                                          unsigned char* y, int pitch_y, unsigned char* cb, int pitch_cb,
                                          unsigned char* cr, int pitch_cr, void* stream) {
  Decoder* d = static_cast<Decoder*>(decoder);
  nvjpegImage_t image = {};
  image.channel[0] = y;
  image.pitch[0] = static_cast<unsigned int>(pitch_y);
  image.channel[1] = cb;
  image.pitch[1] = static_cast<unsigned int>(pitch_cb);
  image.channel[2] = cr;
  image.pitch[2] = static_cast<unsigned int>(pitch_cr);
  int err = status(nvjpegDecode(d->handle, d->state, data, length, NVJPEG_OUTPUT_YUV, &image,
                                static_cast<cudaStream_t>(stream)));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
