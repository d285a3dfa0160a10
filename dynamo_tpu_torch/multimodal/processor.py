"""Image / video loading and prompt expansion for multimodal requests.

The port's own copy of dynamo_tpu/multimodal/processor.py: ``data:`` base64
URLs and local ``file://`` paths (http(s) sources are refused with a clear
error: the deployment has no egress), a resize to the vision tower's square
input, and a normalization to [-1, 1] float32; the placeholder expansion
that sizes the spliced span. Pure numpy and the standard library: a frontend
imports this module, so it imports no torch.

Decoding: the card's machine has neither PIL nor cv2, so PNG (8-bit gray,
gray + alpha, RGB, RGBA and palette, not interlaced, all five scanline
filters) is read by ``decode_png``, this module's own stdlib reader (zlib),
bit for bit what PIL's ``convert("RGB")`` gives (alpha dropped, the palette
looked up); the frames of an animated PNG (``decode_apng``) are a video the
same reader decodes. Other formats and PNG variants (16-bit, sub-byte
depths, Adam7) go to PIL, GIF frames to PIL and other video containers to
cv2, each imported only then; where the package is missing the error names
it, and nothing is substituted. The reference takes no animated PNG as a
video; the port does, so a clip needs no decoder package on the card.
"""

from __future__ import annotations

import base64
import io
import struct
import zlib
from urllib.parse import urlparse

import numpy as np

IMAGE_PLACEHOLDER = "<image>"
VIDEO_PLACEHOLDER = "<video>"

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for 8-bit samples
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _require(module: str, package: str, what: str):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError:
        raise RuntimeError(
            f"{what} needs the {package!r} package, which is not installed here "
            "(PNG images are decoded without it)"
        ) from None


def _unfilter(raw: bytes, width: int, height: int, bpp: int) -> np.ndarray:
    """Undo PNG's per-scanline filters (None, Sub, Up, Average, Paeth) of
    8-bit samples; returns [height, width * bpp] uint8."""
    stride = width * bpp
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif ft == 2:  # Up
            cur = line + prev
        elif ft in (3, 4):
            cur = _unfilter_seq(ft, line.tobytes(), prev.tobytes(), bpp)
        else:
            raise ValueError(f"PNG scanline filter {ft} is not defined")
        out[y] = cur
        prev = cur
    return out


def _unfilter_seq(ft: int, line: bytes, prev: bytes, bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): each byte depends on the one left of it."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ft == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _png_chunks(raw: bytes):
    """(type, data) of every chunk up to IEND, each CRC checked."""
    if not raw.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(raw):
        (length,) = struct.unpack(">I", raw[pos:pos + 4])
        ctype = raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + length]
        if len(data) != length or pos + 12 + length > len(raw):
            raise ValueError("PNG chunk is truncated")
        crc = struct.unpack(">I", raw[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(ctype + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        pos += 12 + length
        yield ctype, data
        if ctype == b"IEND":
            return


def _header(chunks):
    """IHDR's (width, height, colour type), or None for a variant this
    reader leaves to PIL (a bit depth other than 8, Adam7 interlacing, an
    unknown colour type)."""
    ihdr = next((d for t, d in chunks if t == b"IHDR"), None)
    if ihdr is None:
        raise ValueError("PNG has no IHDR chunk")
    width, height, depth, color, compression, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        return None
    if compression != 0 or filt != 0:
        raise ValueError("PNG uses an unknown compression or filter method")
    return width, height, color


def _palette(chunks):
    data = next((d for t, d in chunks if t == b"PLTE"), None)
    return None if data is None else np.frombuffer(data, np.uint8).reshape(-1, 3)


def _pixels(zdata: bytes, width: int, height: int, color: int, palette) -> np.ndarray:
    """One image's zlib stream -> its samples [height, width, channels]
    (a palette looked up to RGB)."""
    bpp = _PNG_CHANNELS[color]
    px = _unfilter(zlib.decompress(zdata), width, height, bpp).reshape(height, width, bpp)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG has no PLTE chunk")
        idx = px[..., 0]
        if idx.size and int(idx.max()) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[idx]
    return px


def _rgb(px: np.ndarray, color: int) -> np.ndarray:
    """Samples -> RGB as PIL's convert("RGB"): alpha dropped, gray to
    three channels."""
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def decode_png(raw: bytes):
    """Decode a PNG to RGB uint8 [H, W, 3] with the standard library, or
    None for a variant this reader leaves to PIL."""
    chunks = list(_png_chunks(raw))
    head = _header(chunks)
    if head is None:
        return None
    width, height, color = head
    idat = b"".join(d for t, d in chunks if t == b"IDAT")
    return _rgb(_pixels(idat, width, height, color, _palette(chunks)), color)


def decode_apng(raw: bytes):
    """The frames of an animated PNG as RGB uint8 [H, W, 3] arrays, each
    the canvas after its frame is drawn (what PIL's frame iterator gives),
    with the standard library; None for a file that is no APNG, or a
    variant left to PIL (a default image outside the animation, a frame
    blended over with partly transparent pixels)."""
    chunks = list(_png_chunks(raw))
    if not any(t == b"acTL" for t, _ in chunks):
        return None
    head = _header(chunks)
    if head is None:
        return None
    width, height, color = head
    palette = _palette(chunks)
    # each frame: its fcTL fields and its image data (IDAT for the first,
    # whose fcTL comes before it; fdAT's after their sequence number)
    frames, seen_idat = [], False
    for t, d in chunks:
        if t == b"fcTL":
            frames.append((struct.unpack(">IIIIIHHBB", d[:26]), []))
        elif t == b"IDAT":
            if not frames:
                return None  # a default image outside the animation
            if not seen_idat:
                frames[-1][1].append(d)
            seen_idat = True
        elif t == b"fdAT" and frames:
            frames[-1][1].append(d[4:])
    canvas = np.zeros((height, width, 3), np.uint8)
    out = []
    for (_, w, h, x, y, _, _, dispose, blend), parts in frames:
        if x + w > width or y + h > height:
            raise ValueError("APNG frame outside the canvas")
        px = _pixels(b"".join(parts), w, h, color, palette)
        if blend == 1 and color in (4, 6) and (px[..., -1] != 255).any():
            return None
        before = canvas.copy()
        canvas[y:y + h, x:x + w] = _rgb(px, color)
        out.append(canvas.copy())
        if dispose == 1:  # to the background: transparent black, black in RGB
            canvas[y:y + h, x:x + w] = 0
        elif dispose == 2:  # back to the canvas before this frame
            canvas = before
    return out


def _decode_image(raw: bytes) -> np.ndarray:
    if raw.startswith(PNG_SIGNATURE):
        img = decode_png(raw)
        if img is not None:
            return img
    pil = _require("PIL.Image", "Pillow", "decoding this image format")
    return np.asarray(pil.open(io.BytesIO(raw)).convert("RGB"), dtype=np.uint8)


def load_image_array(image_url: str) -> np.ndarray:
    """Decode an image source to an RGB uint8 array [H, W, 3]."""
    parsed = urlparse(image_url)
    if parsed.scheme == "data":
        # data:image/png;base64,<payload>
        if not parsed.path.startswith("image/"):
            raise ValueError("data URL must carry an image media type")
        media, _, payload = parsed.path.partition(",")
        if ";base64" not in media:
            raise ValueError("data URL must be base64 encoded")
        raw = base64.b64decode(payload)
    elif parsed.scheme == "file" or not parsed.scheme:
        path = parsed.path if parsed.scheme else image_url
        with open(path, "rb") as f:
            raw = f.read()
    elif parsed.scheme in ("http", "https"):
        raise ValueError(
            "http(s) image sources are not reachable from this deployment; "
            "inline the image as a data: URL"
        )
    else:
        raise ValueError(f"unsupported image source scheme {parsed.scheme!r}")
    return _decode_image(raw)


def preprocess_pixels(img: np.ndarray, image_size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [S, S, 3] in [-1, 1], bilinear resize.

    Pure numpy (deterministic across hosts: every rank must derive
    identical pixels)."""
    H, W, _ = img.shape
    S = image_size
    ys = np.linspace(0, H - 1, S)
    xs = np.linspace(0, W - 1, S)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    img_f = img.astype(np.float32)
    top = img_f[y0][:, x0] * (1 - wx) + img_f[y0][:, x1] * wx
    bot = img_f[y1][:, x0] * (1 - wx) + img_f[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return (out / 127.5 - 1.0).astype(np.float32)


def expand_image_prompt(
    token_ids: list[int], placeholder_id: int, num_patches: int
) -> tuple[list[int], int]:
    """Expand the FIRST placeholder token to ``num_patches`` copies.

    Returns (expanded_ids, mm_start), mm_start the index of the first
    expanded position (-1 when no placeholder is there). The prefill
    overwrites embeddings at [mm_start, mm_start + num_patches)."""
    try:
        i = token_ids.index(placeholder_id)
    except ValueError:
        return list(token_ids), -1
    expanded = (
        list(token_ids[:i])
        + [placeholder_id] * num_patches
        + list(token_ids[i + 1:])
    )
    return expanded, i


def load_video_frames(video_url: str, num_frames: int = 8) -> np.ndarray:
    """Decode a video source to uniformly sampled RGB frames [T, H, W, 3]
    uint8. Sources: local paths / file:// (an animated PNG read by
    ``decode_apng``, any other container cv2 reads), animated GIFs (PIL),
    and data:video/...;base64 payloads (an animated PNG as ``image/apng``,
    ``image/png`` or ``video/apng``; others staged to a temporary file for
    cv2). http(s) is refused, as for images."""
    parsed = urlparse(video_url)
    tmp_path = None
    try:
        if parsed.scheme == "data":
            if not parsed.path.startswith(("video/", "image/gif", "image/apng", "image/png")):
                raise ValueError("data URL must carry a video media type")
            media, _, payload = parsed.path.partition(",")
            if ";base64" not in media:
                raise ValueError("data URL must be base64 encoded")
            raw = base64.b64decode(payload)
            if raw.startswith(PNG_SIGNATURE):
                frames = _decode_png_frames(raw)
            elif "gif" in media:
                frames = _decode_gif_bytes(raw)
            else:
                # cv2's demuxer needs a real path: stage, decode, unlink
                import tempfile

                with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
                    f.write(raw)
                    tmp_path = f.name
                frames = _decode_frames(tmp_path)
        elif parsed.scheme == "file" or not parsed.scheme:
            frames = _decode_frames(parsed.path if parsed.scheme else video_url)
        elif parsed.scheme in ("http", "https"):
            raise ValueError(
                "http(s) video sources are not reachable from this "
                "deployment; inline the video as a data: URL"
            )
        else:
            raise ValueError(f"unsupported video source scheme {parsed.scheme!r}")
        if not frames:
            raise ValueError(f"no decodable frames in {video_url!r}")
        return sample_frames(np.stack(frames), num_frames)
    finally:
        if tmp_path is not None:
            import os

            try:
                os.unlink(tmp_path)
            except OSError:
                pass


def _decode_png_frames(raw: bytes) -> list[np.ndarray]:
    """A PNG's frames: an animated one's by ``decode_apng``, a still one
    as one frame, a variant left to PIL through it."""
    frames = decode_apng(raw)
    if frames is not None:
        return frames
    if not any(t == b"acTL" for t, _ in _png_chunks(raw)):
        single = decode_png(raw)
        if single is not None:
            return [single]
    return _decode_gif_bytes(raw)


def _decode_gif_bytes(raw: bytes) -> list[np.ndarray]:
    """Every frame through PIL (a GIF, or a PNG variant the stdlib reader
    leaves to it)."""
    image = _require("PIL.Image", "Pillow", "decoding GIF frames")
    sequence = _require("PIL.ImageSequence", "Pillow", "decoding GIF frames")
    with image.open(io.BytesIO(raw)) as img:
        return [np.asarray(frame.convert("RGB"), dtype=np.uint8)
                for frame in sequence.Iterator(img)]


def _decode_frames(path: str) -> list[np.ndarray]:
    if path.lower().endswith((".gif", ".png", ".apng")):
        with open(path, "rb") as f:
            raw = f.read()
        return _decode_png_frames(raw) if raw.startswith(PNG_SIGNATURE) else _decode_gif_bytes(raw)
    cv2 = _require("cv2", "opencv-python", "decoding video containers")
    cap = cv2.VideoCapture(path)
    frames: list[np.ndarray] = []
    try:
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            frames.append(bgr[:, :, ::-1].astype(np.uint8))  # BGR -> RGB
    finally:
        cap.release()
    return frames


def sample_frames(frames: np.ndarray, num_frames: int) -> np.ndarray:
    """Uniform temporal sampling to exactly num_frames (frames repeat when
    the clip is shorter: the span keeps a fixed size)."""
    T = frames.shape[0]
    idx = np.linspace(0, T - 1, num_frames).round().astype(np.int64)
    return frames[idx]


def preprocess_video(frames: np.ndarray, image_size: int) -> np.ndarray:
    """[T, H, W, 3] uint8 -> [T, S, S, 3] float32 in [-1, 1]."""
    return np.stack([preprocess_pixels(f, image_size) for f in frames])


def expand_video_prompt(
    token_ids: list[int],
    placeholder_id: int,
    num_frames: int,
    num_patches: int,
) -> tuple[list[int], int]:
    """Expand ONE video placeholder to num_frames * num_patches positions:
    the spliced span carries every frame's patch embeddings in temporal
    order (the image path's single span, so the prefill needs nothing
    video-specific)."""
    return expand_image_prompt(token_ids, placeholder_id, num_frames * num_patches)
