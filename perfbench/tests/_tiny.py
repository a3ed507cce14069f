"""A cell shrunk to a size the CPU runs in seconds: few sensors, one day,
small batches and, for the CPU only, the model its family shrinks."""

from perfbench import manifest


def tiny_cell(name: str, num_nodes: int = 48, **load):
    cell = manifest.load_cell(name, **load)
    cell.config["data"].update(num_nodes=num_nodes, series_days=1)
    cell.config["recipe"]["batch_size"] = 16
    cell.config["reference"]["block"] = 8
    cell.family.tiny(cell.config)
    return cell
