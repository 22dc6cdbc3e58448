"""Published reference RD baselines (the numbers to reproduce), the port's
own copy of `stf_tpu/zoo/published.py`.

Values transcribed from the reference's frozen result files (see
BASELINE.md): 6 lambda points per curve, MSE models trained on 300k
OpenImages. MS-SSIM quality values are -10*log10(1 - MS-SSIM) in dB (the
files' convention).
"""

PUBLISHED_RD = {
    "stf_mse_Kodak": {
        "bpp": [0.124, 0.191, 0.298, 0.441, 0.651, 0.903],
        "quality": [29.14, 30.50, 32.15, 33.97, 35.82, 37.72],
        "metric": "psnr",
    },
    "cnn_mse_Kodak": {
        "bpp": [0.127, 0.199, 0.309, 0.449, 0.649, 0.895],
        "quality": [29.22, 30.59, 32.26, 34.15, 35.91, 37.72],
        "metric": "psnr",
    },
    "stf_mse_CLIC": {
        "bpp": [0.092, 0.144, 0.223, 0.320, 0.483, 0.661],
        "quality": [30.88, 32.24, 33.70, 35.27, 36.90, 38.42],
        "metric": "psnr",
    },
    "cnn_mse_CLIC": {
        "bpp": [0.094, 0.153, 0.229, 0.322, 0.481, 0.671],
        "quality": [30.97, 32.36, 33.85, 35.39, 36.88, 38.43],
        "metric": "psnr",
    },
    "stf_ms-ssim_Kodak": {
        "bpp": [0.109, 0.168, 0.236, 0.340, 0.483, 0.664],
        "quality": [13.63, 14.96, 16.49, 18.17, 20.19, 21.50],
        "metric": "ms-ssim-db",
    },
    "cnn_ms-ssim_Kodak": {
        "bpp": [0.115, 0.177, 0.254, 0.361, 0.496, 0.684],
        "quality": [13.79, 15.12, 16.93, 18.48, 20.16, 21.69],
        "metric": "ms-ssim-db",
    },
    "stf_ms-ssim_CLIC": {
        "bpp": [0.098, 0.134, 0.192, 0.268, 0.394, 0.548],
        "quality": [14.79, 15.88, 17.15, 18.63, 20.57, 22.39],
        "metric": "ms-ssim-db",
    },
    "cnn_ms-ssim_CLIC": {
        "bpp": [0.106, 0.145, 0.207, 0.292, 0.407, 0.564],
        "quality": [15.04, 16.04, 17.53, 18.92, 20.83, 22.60],
        "metric": "ms-ssim-db",
    },
}
