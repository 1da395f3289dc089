// Kernel 10: both images of a stereo pair rectified in one launch.
//
// Replaces (JAX reference): geometry/rectify.py remap_pair (:94) over
// remap_bilinear (:64-91): each output pixel samples its image at its
// map's source coordinates, bilinearly, 0 outside the image
// (cv::remap's BORDER_CONSTANT).  On the main path two f32 [480, 640]
// images and two f32 [480, 640, 2] maps.
//
// Bound: bytes.  Per output pixel the map's 8 bytes and the output's 4; the
// four taps are gathers that neighbouring threads share through L1 and L2,
// and each image is counted read once (4 bytes a pixel).  A handful of
// operations a pixel is far below the card's rate.
//
// Design: one thread an output pixel, blockIdx.y the image.  The
// arithmetic is the reference's: x0 = floor(x), fx = x - x0, the four taps
// (0 outside), top = v00 (1 - fx) + v01 fx, bot likewise,
// out = top (1 - fy) + bot fy, each operation rounded once (built with
// --fmad=false), so an integer source coordinate returns its pixel bit for
// bit, and the plain torch twin (kernels/remap.py remap_pair_plain) agrees
// bit for bit.

#include <cuda_runtime.h>

#define NT 256

__device__ __forceinline__ float tap(const float* img, int H, int W, int y, int x) {
    return (x >= 0 && x < W && y >= 0 && y < H) ? img[(size_t)y * W + x] : 0.f;
}

__global__ void __launch_bounds__(NT) remap_pair_kernel(const float* img_l, const float* img_r,
                                                        const float* map_l, const float* map_r,
                                                        float* out_l, float* out_r, int H, int W,
                                                        int Ho, int Wo) {
    const int p = blockIdx.x * NT + threadIdx.x;
    if (p >= Ho * Wo) return;
    const bool right = blockIdx.y == 1;
    const float* img = right ? img_r : img_l;
    const float2 m = reinterpret_cast<const float2*>(right ? map_r : map_l)[p];
    const float x0 = floorf(m.x), y0 = floorf(m.y);
    const float fx = m.x - x0, fy = m.y - y0;
    const int xi = (int)x0, yi = (int)y0;
    const float v00 = tap(img, H, W, yi, xi), v01 = tap(img, H, W, yi, xi + 1);
    const float v10 = tap(img, H, W, yi + 1, xi), v11 = tap(img, H, W, yi + 1, xi + 1);
    const float top = v00 * (1.f - fx) + v01 * fx;
    const float bot = v10 * (1.f - fx) + v11 * fx;
    (right ? out_r : out_l)[p] = top * (1.f - fy) + bot * fy;
}

extern "C" int remap_pair_launch(const float* img_l, const float* img_r, const float* map_l,
                                 const float* map_r, float* out_l, float* out_r, int H, int W,
                                 int Ho, int Wo, cudaStream_t stream) {
    if (Ho * Wo == 0) return (int)cudaGetLastError();
    remap_pair_kernel<<<dim3((Ho * Wo + NT - 1) / NT, 2), NT, 0, stream>>>(
        img_l, img_r, map_l, map_r, out_l, out_r, H, W, Ho, Wo);
    return (int)cudaGetLastError();
}
