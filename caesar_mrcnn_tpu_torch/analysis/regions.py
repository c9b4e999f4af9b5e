"""DS9 region-file writing (no external `regions` dependency).

Produces class-colored polygon regions with name/class/BORDER/MERGED tags,
matching the reference's output role (reference: mrcnn/analyze.py:1960-2034,
mrcnn/sfinder.py:1436-1518). Region coordinates are written in DS9 image
convention (1-based pixel centers).

The port's copy of ``caesar_mrcnn_tpu/analysis/regions.py``, unchanged in behaviour
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

# default class -> DS9 color map (reference color scheme intent)
DEFAULT_CLASS_COLORS: Dict[str, str] = {
    "bkg": "black",
    "sidelobe": "orange",
    "spurious": "orange",
    "source": "red",
    "compact": "red",
    "galaxy": "green",
    "extended": "green",
    "extended-multisland": "cyan",
    "flagged": "magenta",
}


class DS9Region:
    def __init__(
        self,
        polygon_xy: Sequence[Sequence[float]],
        name: str = "",
        color: str = "green",
        tags: Optional[List[str]] = None,
    ):
        self.polygon_xy = polygon_xy
        self.name = name
        self.color = color
        self.tags = tags or []

    def to_line(self) -> str:
        # DS9 image coords are 1-based pixel centers
        coords = ",".join(
            f"{x + 1:.2f},{y + 1:.2f}" for x, y in self.polygon_xy
        )
        attrs = [f"color={self.color}"]
        if self.name:
            attrs.append(f"text={{{self.name}}}")
        for t in self.tags:
            attrs.append(f"tag={{{t}}}")
        return f"polygon({coords}) # " + " ".join(attrs)


def make_regions_from_objs(
    objs: Iterable[Dict],
    class_colors: Optional[Dict[str, str]] = None,
) -> List[DS9Region]:
    """Objects from the JSON catalog -> polygon regions, one per contour
    (reference: mrcnn/analyze.py:1966-2014)."""
    colors = dict(DEFAULT_CLASS_COLORS)
    if class_colors:
        colors.update(class_colors)
    regions: List[DS9Region] = []
    for obj in objs:
        tags = [obj.get("class_name", "")]
        if obj.get("edge"):
            tags.append("BORDER")
        if obj.get("merged"):
            tags.append("MERGED")
        color = colors.get(obj.get("class_name", ""), "white")
        for contour in obj.get("vertexes", []):
            if len(contour) < 3:
                continue
            regions.append(
                DS9Region(contour, name=obj.get("name", ""), color=color, tags=tags)
            )
    return regions


def write_ds9_regions(regions: Sequence[DS9Region], outfile: str) -> None:
    with open(outfile, "w") as f:
        f.write("# Region file format: DS9\n")
        f.write("image\n")
        for r in regions:
            f.write(r.to_line() + "\n")
