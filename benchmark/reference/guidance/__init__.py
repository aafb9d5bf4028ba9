"""Zero-1-to-3's UNet, VAE and CLIP image tower by ldm's layer equations,
and its SDS loss (the port's guidance/, frozen)."""
