"""Batched serving demo: prefill a prompt batch then decode tokens, on any
registered architecture at its reduced size (the twin of
``examples/serve_decode.py``; ring-cache SWA, the MLA latent cache and
xLSTM's recurrent-state decode are each reached by ``--arch``):

    python -m repro_torch.examples.serve_decode --arch mixtral-8x7b --device cpu
    python -m repro_torch.examples.serve_decode --arch xlstm-1.3b

runs on the card unless ``--device cpu`` is given; the flags are
``repro_torch.launch.serve``'s.
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
