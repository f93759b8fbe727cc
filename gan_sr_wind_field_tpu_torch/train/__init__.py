from gan_sr_wind_field_tpu_torch.train.gan import GANTrainState, WindFieldGAN

__all__ = ["GANTrainState", "WindFieldGAN"]
