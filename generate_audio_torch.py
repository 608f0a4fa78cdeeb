#!/usr/bin/env python
"""`python generate_audio_torch.py <flags>`: generate_audio.py on the port."""
from pix2pixhdaudiosr_torch.generate import main
from pix2pixhdaudiosr_torch.parallel import mesh
if __name__ == "__main__":
    main()
    mesh.shutdown()
