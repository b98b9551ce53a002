"""Direct-convolution operations of a whole paint call and training step,
per tile or sample, from a configuration's layer lists (``shapes``).

CVAE painting runs the prior net on the input and its redshift map and the
decoder (``p_z_in`` on the latent, ``p_y_in``, the trunk ``p_y_z_in`` and
both heads); a training step's forward runs all of that and the
recognition net (``q_x_in``, ``q_y_in``, ``q_x_y_out``). The CGAN paints
through its generator's body and head. Channel counts follow the CVAE's
concatenations: the redshift map joins the input (one channel), the
decoder's trunk reads p_z_in's output beside p_y_in's.
"""
from __future__ import annotations

from benchmark.counts.shapes import conv_flops, walk

__all__ = ["cvae_paint_flops", "cvae_train_forward_flops",
           "cgan_paint_flops", "cvae_res_blocks", "cvae_trunk",
           "paint_flops", "paint_res_blocks", "cvae_k4_sites"]


def _flops(spec, c, h, w):
    records, out = walk(spec, c, h, w)
    return conv_flops(records), out


def _prior_and_decoder(arch: dict, tile: int):
    n_in = arch["dim_y"][0] + 1            # the input and its redshift map
    cz = arch["dim_z"][0]
    f = arch["dim_y"][1] // arch["dim_z"][1]
    prior, _ = _flops(arch["prior_z_y"], n_in, tile, tile)
    pz, (c_z, _, _) = _flops(arch["p_z_in"], cz, tile // f, tile // f)
    py, (c_y, _, _) = _flops(arch.get("p_y_in"), n_in, tile, tile)
    trunk, (c_t, _, _) = _flops(arch["p_y_z_in"], c_z + c_y, tile, tile)
    heads = sum(_flops(spec, c_t, tile, tile)[0]
                for spec in arch["p_y_z_out"])
    return prior + pz + py + trunk + heads


def cvae_paint_flops(arch: dict, tile: int) -> float:
    """Operations a tile of a CVAE paint call: prior and decoder."""
    return _prior_and_decoder(arch, tile)


def cvae_train_forward_flops(arch: dict, tile: int) -> float:
    """Operations of a training sample's forward: the recognition net, the
    prior net and the decoder."""
    n_x = arch["dim_x"][0]
    n_in = arch["dim_y"][0] + 1
    qx, (c1, h, w) = _flops(arch["q_x_in"], n_x, tile, tile)
    qy, (c2, _, _) = _flops(arch["q_y_in"], n_in, tile, tile)
    qo, _ = _flops(arch["q_x_y_out"], c1 + c2, h, w)
    return qx + qy + qo + _prior_and_decoder(arch, tile)


def cgan_paint_flops(generator: dict, tile: int) -> float:
    """Operations a tile of a CGAN paint call: body and head."""
    body, (c, h, w) = _flops(generator["body"], generator["in_channels"],
                             tile, tile)
    head, _ = _flops(generator["head"], c, h, w)
    return body + head


def cvae_trunk(arch: dict, tile: int) -> list:
    """``walk``'s records of the CVAE's trunk (p_y_z_in) at ``tile``."""
    f = arch["dim_y"][1] // arch["dim_z"][1]
    _, (c_z, _, _) = walk(arch["p_z_in"], arch["dim_z"][0], tile // f,
                          tile // f)
    _, (c_y, _, _) = walk(arch.get("p_y_in"), arch["dim_y"][0] + 1, tile,
                          tile)
    return walk(arch["p_y_z_in"], c_z + c_y, tile, tile)[0]


def cvae_res_blocks(arch: dict, tile: int) -> list:
    """(channels, h, w) of each residual block of the CVAE's trunk."""
    return [(r["c"], r["h"], r["w"]) for r in cvae_trunk(arch, tile)
            if r["kind"] == "res_block"]


def paint_flops(config: dict, tile: int) -> float:
    """Operations a tile of a paint call of ``config``'s model."""
    if config["model"] == "cvae":
        return cvae_paint_flops(config["architecture"], tile)
    return cgan_paint_flops(config["generator"], tile)


def paint_res_blocks(config: dict, tile: int) -> list:
    """(channels, h, w) of each residual block a paint call runs."""
    if config["model"] == "cvae":
        return cvae_res_blocks(config["architecture"], tile)
    gen = config["generator"]
    records, _ = walk(gen["body"], gen["in_channels"], tile, tile)
    return [(r["c"], r["h"], r["w"]) for r in records
            if r["kind"] == "res_block"]


def cvae_k4_sites(arch: dict, tile: int) -> list:
    """``walk``'s records of the trunk's train-mode (conv, batch norm,
    ReLU) triples that K4 computes: a bias-free convolution of 8 or more
    output channels that is transposed or of stride 1."""
    spec = list(arch["p_y_z_in"])
    _, (c, h, w) = walk(arch["p_z_in"], arch["dim_z"][0],
                        *(2 * [tile // (arch["dim_y"][1]
                                        // arch["dim_z"][1])]))
    c += arch["dim_y"][0] + 1
    names = [str(layer[0]).lower() for layer in spec] + ["", ""]
    sites = []
    for i, layer in enumerate(spec):
        rec, (c, h, w) = walk([layer], c, h, w)
        if (names[i] in ("conv", "transp conv")
                and names[i + 1:i + 3] == ["batchnorm", "relu"]
                and not layer[1].get("bias", True)
                and layer[1]["out_channels"] >= 8
                and (names[i] == "transp conv"
                     or layer[1].get("stride", 1) == 1)):
            sites.append(rec[0])
    return sites
