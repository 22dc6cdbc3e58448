from .metrics import ms_ssim, psnr, ssim

__all__ = ["ms_ssim", "psnr", "ssim"]
