"""Serve a small model on the PyTorch port with batched requests:
prefill + decode loop.

Run:  PYTHONPATH=src python examples/torch/serve_decode.py --arch gemma3-1b --smoke
(--device cpu runs the kernels' plain versions on the CPU.)
"""

import argparse

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import serve_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    r = serve_loop(cfg, batch=args.batch, prompt_len=args.prompt_len,
                   gen_tokens=args.gen_tokens, device=args.device)
    print(f"{cfg.name}: prefill {r['prefill_s']*1e3:.1f} ms | "
          f"decode {r['decode_tok_s']:.1f} tok/s (batch {args.batch})")
    print("sample tokens:", r["generated"][0, :16].tolist())


if __name__ == "__main__":
    main()
