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
// A 4-component JPEG (Adobe CMYK or YCCK) comes back as its four stored
// components, unconverted (NVJPEG_OUTPUT_UNCHANGED through the decoupled
// API, whose decode parameters take AllowCMYK): the wrapper converts them
// with PIL's formulas, since nvJPEG's own CMYK conversion is not PIL's.
//
// A decoder is one handle and one decode state (tinyedm_jpeg_create), and,
// from the first 4-component JPEG on, the decoupled API's decoder, state,
// buffers, stream and parameters; the Python wrapper holds a lock around
// every call on it, since a state is not shared between concurrent decodes.
//
// Return codes: 0; a negative nvjpegStatus_t (-status); or a positive
// cudaError_t (tinyedm_error_string names it).
#include <nvjpeg.h>

#include "common.cuh"

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  // the decoupled API, for 4-component JPEGs (made at the first one)
  nvjpegJpegDecoder_t decoder = nullptr;
  nvjpegJpegState_t decoder_state = nullptr;
  nvjpegBufferPinned_t pinned = nullptr;
  nvjpegBufferDevice_t device = nullptr;
  nvjpegJpegStream_t stream = nullptr;
  nvjpegDecodeParams_t params = nullptr;
};

int status(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : -static_cast<int>(s); }

int make_decoupled(Decoder* d) {
  if (d->params) return 0;
  int err = status(nvjpegDecoderCreate(d->handle, NVJPEG_BACKEND_DEFAULT, &d->decoder));
  if (!err) err = status(nvjpegDecoderStateCreate(d->handle, d->decoder, &d->decoder_state));
  if (!err) err = status(nvjpegBufferPinnedCreate(d->handle, nullptr, &d->pinned));
  if (!err) err = status(nvjpegBufferDeviceCreate(d->handle, nullptr, &d->device));
  if (!err) err = status(nvjpegStateAttachPinnedBuffer(d->decoder_state, d->pinned));
  if (!err) err = status(nvjpegStateAttachDeviceBuffer(d->decoder_state, d->device));
  if (!err) err = status(nvjpegJpegStreamCreate(d->handle, &d->stream));
  nvjpegDecodeParams_t params = nullptr;
  if (!err) err = status(nvjpegDecodeParamsCreate(d->handle, &params));
  if (!err) err = status(nvjpegDecodeParamsSetOutputFormat(params, NVJPEG_OUTPUT_UNCHANGED));
  if (!err) err = status(nvjpegDecodeParamsSetAllowCMYK(params, 1));
  if (!err) {
    d->params = params;
  } else if (params) {
    nvjpegDecodeParamsDestroy(params);
  }
  return err;
}

// the four stored components of a 4-component JPEG into image's planes
int decode_unchanged(Decoder* d, const unsigned char* data, size_t length, nvjpegImage_t* image,
                     cudaStream_t stream) {
  int err = make_decoupled(d);
  if (!err) err = status(nvjpegJpegStreamParse(d->handle, data, length, 0, 0, d->stream));
  if (!err) err = status(nvjpegDecodeJpegHost(d->handle, d->decoder, d->decoder_state, d->params, d->stream));
  if (!err)
    err = status(nvjpegDecodeJpegTransferToDevice(d->handle, d->decoder, d->decoder_state, d->stream, stream));
  if (!err) err = status(nvjpegDecodeJpegDevice(d->handle, d->decoder, d->decoder_state, image, stream));
  return err;
}

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
  if (d->params) nvjpegDecodeParamsDestroy(d->params);
  if (d->stream) nvjpegJpegStreamDestroy(d->stream);
  if (d->decoder_state) nvjpegJpegStateDestroy(d->decoder_state);
  if (d->pinned) nvjpegBufferPinnedDestroy(d->pinned);
  if (d->device) nvjpegBufferDeviceDestroy(d->device);
  if (d->decoder) nvjpegDecoderDestroy(d->decoder);
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

// decode into the planes on the card, one byte a sample, each with its
// pitch: Y, Cb, Cr (a grey JPEG fills Y alone; the others may then be null),
// or, when the fourth plane is given, the four stored components of a
// 4-component JPEG (C, M, Y, K, or Y, Cb, Cr, K of a YCCK file), unconverted
extern "C" int tinyedm_jpeg_decode_planes(void* decoder, const unsigned char* data, size_t length,
                                          unsigned char* p0, int pitch0, unsigned char* p1, int pitch1,
                                          unsigned char* p2, int pitch2, unsigned char* p3, int pitch3,
                                          void* stream) {
  Decoder* d = static_cast<Decoder*>(decoder);
  nvjpegImage_t image = {};
  unsigned char* planes[4] = {p0, p1, p2, p3};
  const int pitches[4] = {pitch0, pitch1, pitch2, pitch3};
  for (int i = 0; i < 4; ++i) {
    image.channel[i] = planes[i];
    image.pitch[i] = static_cast<unsigned int>(pitches[i]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = p3 ? decode_unchanged(d, data, length, &image, s)
               : status(nvjpegDecode(d->handle, d->state, data, length, NVJPEG_OUTPUT_YUV, &image, s));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
